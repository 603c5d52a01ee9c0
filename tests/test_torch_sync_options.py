"""The options of sync_common, framesync_fixed and decode_payload_symbols,
and symbols_from_windows, in the PyTorch port against the JAX package, on
one small stream (B = 2, T = 8192) of QPSK + V27 + Golay frames with CFO,
carrier phase, fractional delay, gain and AWGN at 14 dB. Options that do not
interact share a case, so that the JAX receiver compiles once a case.

Discrete fields are exact; floats within the tolerances that
tests/test_torch_framesync.py pins (symbols 2e-3 x max, evm 0.02 dB, rssi
1e-3 dB, cfo 1e-6 rad/sample)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.kernels.extract import extract_windows as jextract
from liquiddsp_tpu.phy import frame_spec as jfs
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu.phy import framesync as jsync
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.phy import framesync as tsync
from liquiddsp_tpu_torch.phy.detector import Detections


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's tests: the suite runs in several
    worker processes at once, and torch's default of a thread a core
    oversubscribes them (alone, these tests run as fast on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = (1, 1, 1, 64)
B, T, SNR_DB = 2, 8192, 14.0
DET_FIELDS = ("mask", "start", "rho", "gamma", "dphi", "phi", "tau")
FIELDS = ("header_valid", "payload_valid", "modulation", "inner_code", "outer_code",
          "payload_len", "header_user")

# (entry point, options): each option of step 5 in at least one case
CASES = {
    "sync_common: refine, fine off; peak count, header ref": (
        "sync_common", dict(refine=False, fine=False, return_peak_count=True,
                            return_hdr_ref=True)),
    "framesync_fixed: timing_bank off, track off": (
        "framesync_fixed", dict(timing_bank=False, track=False)),
    "framesync_fixed: equalize off, noise_var_override": (
        "framesync_fixed", dict(equalize=False, noise_var_override=0.05)),
    "framesync_fixed: equalize and refine off, peak count": (
        "framesync_fixed", dict(equalize=False, refine=False, return_peak_count=True)),
    "framesync_fixed: track_sfo on a short frame, det_override": (
        "framesync_fixed", dict(track_sfo=True, det_override=True)),
}


def frac_delay(x, d):
    n = np.arange(-24, 25)
    h = np.sinc(n - d) * np.hamming(len(n))
    h /= h.sum()
    return np.stack([np.convolve(r, h, mode="same") for r in x])


@functools.lru_cache(maxsize=None)
def stream():
    """(x [B, T] complex64, payloads [B, 64], frame starts, max_frames)."""
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, (B, CFG[3]), dtype=np.uint8)
    frames = np.asarray(jframegen.framegen(jnp.asarray(payload), JFrameConfig(*CFG)))
    f = frames.shape[1]
    x = np.zeros((B, T), np.complex128)
    pos, n, starts = 173, np.arange(f), []
    while pos + f + 40 <= T:
        x[:, pos : pos + f] += rng.uniform(0.7, 1.4) * frames * np.exp(
            1j * (rng.uniform(-0.015, 0.015) * n + rng.uniform(-3, 3)))
        starts.append(pos)
        pos += f + int(rng.integers(200, 600))
    x = frac_delay(x, rng.uniform(-0.45, 0.45))
    sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / (2 * 10 ** (SNR_DB / 10)))
    x += sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64), payload, starts, len(starts) + 2


def run_both(entry, opts):
    x, _, _, k = stream()
    opts = dict(opts)
    jopts, topts = dict(opts), dict(opts)
    if opts.get("det_override"):
        jdet = jsync.detect(jnp.asarray(x), k, fine=False)
        jopts["det_override"] = jdet
        topts["det_override"] = Detections.from_numpy(
            {f: np.asarray(getattr(jdet, f)) for f in DET_FIELDS}, "cpu")
    det_j = jopts.pop("det_override", None)
    if entry == "sync_common":
        n_syms = jfs.FrameSpec(JFrameConfig(*CFG)).frame_syms
        fn = jax.jit(functools.partial(jsync.sync_common, n_syms=n_syms, max_frames=k, **jopts))
        ref = fn(jnp.asarray(x))
        got = tsync.sync_common(torch.from_numpy(x), n_syms, k, device="cpu", **topts)
    else:
        fn = jax.jit(functools.partial(jsync.framesync_fixed, cfg=JFrameConfig(*CFG),
                                       max_frames=k, **jopts))
        ref = fn(jnp.asarray(x), det_override=det_j) if det_j is not None else fn(jnp.asarray(x))
        got = tsync.framesync_fixed(torch.from_numpy(x), FrameConfig(*CFG), k, device="cpu", **topts)
    return ref, got


def close_symbols(ref, got, m):
    ref, got = np.asarray(ref), got.numpy()
    assert got.dtype == np.complex64 and got.shape == ref.shape
    np.testing.assert_allclose(got[m], ref[m], atol=2e-3 * np.abs(ref[m]).max())


@pytest.mark.parametrize("case", list(CASES))
def test_option_set_equals_jax(case):
    entry, opts = CASES[case]
    ref, got = run_both(entry, opts)
    _, payload, starts, _ = stream()
    if entry == "sync_common":
        (jdet, jsyms, jf, jevm, jcount, jhdr), (det, syms, f, evm, count, hdr) = ref, got
        m = np.asarray(jdet.mask)
        for name in ("mask", "start"):
            np.testing.assert_array_equal(getattr(det, name).numpy(), np.asarray(getattr(jdet, name)))
        np.testing.assert_allclose(det.dphi.numpy()[m], np.asarray(jdet.dphi)[m], atol=1e-6)
        close_symbols(jsyms, syms, m)
        for a, b in zip(jf, f):
            np.testing.assert_array_equal(b.numpy()[m], np.asarray(a)[m])
        np.testing.assert_allclose(evm.numpy()[m], np.asarray(jevm)[m], rtol=5e-3)
        np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
        hv = np.asarray(jf[0]) & m
        assert hv.sum() == B * len(starts)  # every header decodes at this SNR
        np.testing.assert_array_equal(hdr.numpy()[hv], np.asarray(jhdr)[hv])
        return
    if opts.get("return_peak_count"):
        (ref, jcount), (got, count) = ref, got
        assert count.dtype == torch.int32
        np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
        assert (count.numpy() >= len(starts)).all()
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_array_equal(got.start.numpy(), np.asarray(ref.start))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy()[m],
                                      np.asarray(getattr(ref, name))[m], err_msg=name)
    v = np.asarray(ref.payload_valid)
    np.testing.assert_array_equal(got.payload.numpy()[v], np.asarray(ref.payload)[v])
    for b in range(B):  # what decodes is what was sent
        assert (got.payload.numpy()[b][v[b]] == payload[b]).all()
    close_symbols(ref.symbols, got.symbols, m)
    for name, atol in (("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6)):
        np.testing.assert_allclose(getattr(got, name).numpy()[m],
                                   np.asarray(getattr(ref, name))[m], atol=atol, err_msg=name)


@functools.lru_cache(maxsize=None)
def jax_front_end():
    x, _, _, k = stream()
    n_syms = jfs.FrameSpec(JFrameConfig(*CFG)).frame_syms
    return jax.jit(functools.partial(jsync.sync_common, n_syms=n_syms, max_frames=k))(
        jnp.asarray(x))


@pytest.mark.parametrize("track,noise_var", [(True, None), (False, 0.3)])
def test_decode_payload_symbols_without_anchor_equals_jax(track, noise_var):
    """The self-describing receiver's call form (no anchor: the header-tail
    V&V anchor; noise 0.1 when not given), and without the tracker, on the
    JAX package's own equalized symbols."""
    _, payload, starts, _ = stream()
    det, syms, fields, evm = jax_front_end()
    pj, okj = jsync.decode_payload_symbols(syms, JFrameConfig(*CFG), track=track,
                                           noise_var=noise_var)
    pt, okt = tsync.decode_payload_symbols(torch.from_numpy(np.array(syms)), FrameConfig(*CFG),
                                           track=track, noise_var=noise_var)
    m = np.asarray(det.mask)
    np.testing.assert_array_equal(okt.numpy()[m], np.asarray(okj)[m])
    assert okt.numpy()[m].sum() == B * len(starts)
    np.testing.assert_array_equal(pt.numpy()[m], np.asarray(pj)[m])


@pytest.mark.parametrize("timing_bank", [True, False])
def test_symbols_from_windows_equals_jax(timing_bank):
    """The static path on complex windows, with each candidate's delay row or
    the symmetric prototype, on the JAX package's detections and windows:
    atol 2e-4 x max|ref| as tests/test_kernels.py pins its recover kernel."""
    x, _, _, k = stream()
    n_syms = jfs.FrameSpec(JFrameConfig(*CFG)).frame_syms
    jdet = jsync.detect(jnp.asarray(x), k)
    win = jextract(jnp.asarray(x), jdet.start, 2 * n_syms + 28)
    ref = np.asarray(jsync.symbols_from_windows(win, jdet, n_syms, timing_bank))
    det = Detections.from_numpy({f: np.asarray(getattr(jdet, f)) for f in DET_FIELDS}, "cpu")
    got = tsync.symbols_from_windows(torch.from_numpy(np.array(win)), det, n_syms, timing_bank)
    m = np.asarray(jdet.mask)
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy()[m], ref[m], atol=2e-4 * np.abs(ref[m]).max())
