"""The resampled receiver (BASELINE config 3, bench.py's bench_resampled) of
the PyTorch port against the JAX package: one numpy stream of QPSK frames
(1,0,0,64) at 20 dB, [4, 8192] with one channel in each of the bench's four
sample-clock groups (-50, -20, +20, +50 ppm), through arbitrary_groups (bf16
planes, rank 4) and framesync_fixed in both packages. The valid frames must
be the same by start, their payloads the same and equal to those sent, and
at least every frame that ends 64 samples clear of the block's end must
decode (the bench's tail_margin). framesync.extract_symbols is held against
the JAX package's on the resampled block."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.ops import resample as jres
from liquiddsp_tpu.phy import frame_spec as jfs
from liquiddsp_tpu.phy import framesync as jsync
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.ops import resample as tres
from liquiddsp_tpu_torch.phy import framesync as tsync
from liquiddsp_tpu_torch.phy.detector import Detections
from liquiddsp_tpu_torch.streams import RESAMPLED_PPMS, RESAMPLED_TAIL_MARGIN, resampled_stream

CFG, SNR, B, T = (1, 0, 0, 64), 20.0, 4, 8192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def stream():
    """The port's resampled_stream on the CPU, as numpy."""
    x, payloads, n_frames, max_frames, rates = resampled_stream(
        FrameConfig(*CFG), SNR, B, T, RESAMPLED_PPMS, torch.Generator().manual_seed(3), "cpu")
    return x.numpy(), payloads.numpy(), n_frames, max_frames, rates


@functools.lru_cache(maxsize=None)
def jax_result():
    x, _, _, max_frames, rates = stream()

    @jax.jit
    def rx(x):
        y = jres.arbitrary_groups(x, rates, T, compute_dtype=jnp.bfloat16, rank=4)
        return jsync.framesync_fixed(y.astype(jnp.complex64), JFrameConfig(*CFG), max_frames)

    res = rx(jnp.asarray(x))
    return {k: np.asarray(getattr(res, k)) for k in ("payload_valid", "start", "payload")}


@functools.lru_cache(maxsize=None)
def port_result():
    x, _, _, max_frames, rates = stream()
    y = tres.arbitrary_groups(torch.from_numpy(x), rates, T, compute_dtype=torch.bfloat16,
                              rank=4).to(torch.complex64)
    res = tsync.framesync_fixed(y, FrameConfig(*CFG), max_frames, device="cpu")
    return {k: getattr(res, k).numpy() for k in ("payload_valid", "start", "payload")}


@functools.lru_cache(maxsize=None)
def jax_resampled():
    x, _, _, _, rates = stream()
    return np.asarray(jres.arbitrary_groups(jnp.asarray(x), rates, T, compute_dtype=jnp.bfloat16,
                                            rank=4))


def valid_frames(res, b):
    v = res["payload_valid"][b]
    return {int(s): bytes(p) for s, p in zip(res["start"][b][v], res["payload"][b][v])}


def test_stream_layout():
    x, payloads, n_frames, max_frames, rates = stream()
    assert x.shape == (B, T) and x.dtype == np.complex64
    assert rates == tuple(1.0 + p * 1e-6 for p in (-50.0, -20.0, 20.0, 50.0))
    assert RESAMPLED_TAIL_MARGIN == 64  # bench.py's tail_margin for this configuration
    assert n_frames >= 1 and max_frames >= n_frames + 2
    with pytest.raises(ValueError, match="groups"):
        resampled_stream(FrameConfig(*CFG), SNR, 6, T, RESAMPLED_PPMS, torch.Generator(), "cpu")


@pytest.mark.parametrize("row", range(B))
def test_same_frames_by_start_as_jax(row):
    ref, got = valid_frames(jax_result(), row), valid_frames(port_result(), row)
    assert got == ref


@pytest.mark.parametrize("row", range(B))
def test_payloads_are_those_sent(row):
    _, payloads, n_frames, _, _ = stream()
    got = valid_frames(port_result(), row)
    assert len(got) >= n_frames
    assert all(p == payloads[row].tobytes() for p in got.values())


def test_resampler_bf16_equals_jax():
    x, _, _, _, rates = stream()
    ref = jax_resampled()
    got = tres.arbitrary_groups(torch.from_numpy(x), rates, T, compute_dtype=torch.bfloat16,
                                rank=4).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-2 * np.abs(ref).max())
    assert np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)) < 5e-3


@pytest.mark.parametrize("timing_bank", [True, False])
def test_extract_symbols_equals_jax(timing_bank):
    """framesync.extract_symbols (windows at the detected starts, then the
    derotation and matched filter of symbols_from_windows) on the JAX
    package's detections of the resampled block: within 1e-4 x max|ref|
    (float32 sums of 30 taps in another order, phases up to ~1e3 rad)."""
    max_frames = stream()[3]
    y = jax_resampled().astype(np.complex64)
    jdet = jsync.detect(jnp.asarray(y), max_frames, fine=False)
    n_syms = jfs.FrameSpec(JFrameConfig(*CFG)).frame_syms
    ref = np.asarray(jsync.extract_symbols(jnp.asarray(y), jdet, n_syms, timing_bank))
    det = Detections.from_numpy(
        {f: np.asarray(getattr(jdet, f)) for f in ("mask", "start", "rho", "gamma", "dphi", "phi", "tau")},
        "cpu")
    got = tsync.extract_symbols(torch.from_numpy(y), det, n_syms, timing_bank).numpy()
    m = np.asarray(jdet.mask)
    assert got.shape == ref.shape and m.any()
    np.testing.assert_allclose(got[m], ref[m], atol=1e-4 * np.abs(ref[m]).max())
