"""ops/agc, ops/nco, ops/fir and the integer resamplers of ops/resample in
the PyTorch port against the JAX package on the same numpy inputs: float32
results within 1e-5 x max|ref| (the per-sample loops agc_scan and pll_track
over 2048 samples within 1e-4: the recurrences carry float32 rounding from
step to step); and the behaviour cases of tests/test_dsp_ops.py (TestAGC,
TestNCO, TestResample), mirrored on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.ops import agc as jagc
from liquiddsp_tpu.ops import fir as jfir
from liquiddsp_tpu.ops import nco as jnco
from liquiddsp_tpu.ops import resample as jres
from liquiddsp_tpu_torch.ops import agc, fir, nco, resample


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's tests: the suite runs in several
    worker processes at once, and torch's default of a thread a core
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows(shape, complex_=True, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    x = scale * rng.standard_normal(shape)
    if complex_:
        x = x + 1j * scale * rng.standard_normal(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


def assert_close(got, ref, rel):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max(), rtol=0)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("name,kw,rel", [
    ("agc_block", {}, 1e-5), ("agc_block", {"target_rms": 0.5}, 1e-5),
    ("agc_windowed", {}, 1e-5), ("agc_windowed", {"window": 64, "target_rms": 2.0}, 1e-5),
    ("agc_scan", {}, 1e-4), ("agc_scan", {"alpha": 0.05}, 1e-4),
])
def test_agc_equals_jax(name, kw, rel, complex_):
    x = rows((3, 2048), complex_)
    ref = getattr(jagc, name)(jnp.asarray(x), **kw)
    got = getattr(agc, name)(torch.from_numpy(x), **kw)
    for g, r in zip(got, ref):
        assert_close(g, r, rel)


@pytest.mark.parametrize("per_row", [True, False])
def test_mix_down_and_up_equal_jax(per_row):
    x = rows((3, 2048))
    if per_row:
        dphi = np.array([0.03, -0.011, 0.002], np.float32)
        phi = np.array([0.5, -1.0, 2.0], np.float32)
    else:
        dphi, phi = 0.021, 0.3
    for name in ("mix_down", "mix_up"):
        ref = getattr(jnco, name)(jnp.asarray(x), jnp.asarray(dphi), jnp.asarray(phi))
        got = getattr(nco, name)(torch.from_numpy(x), torch.as_tensor(dphi), torch.as_tensor(phi))
        assert_close(got, ref, 1e-5)


@pytest.mark.parametrize("bw", [0.02, 0.05])
def test_pll_track_equals_jax(bw):
    rng = np.random.default_rng(4)
    ref_syms = np.exp(1j * rng.integers(0, 4, (3, 2048)) * np.pi / 2).astype(np.complex64)
    syms = ref_syms * np.exp(1j * (0.002 * np.arange(2048) + 0.3))
    syms = (syms + 0.1 * rows((3, 2048), seed=5, scale=1.0)).astype(np.complex64)
    ref = jnco.pll_track(jnp.asarray(syms), jnp.asarray(ref_syms), bw)
    got = nco.pll_track(torch.from_numpy(syms), torch.from_numpy(ref_syms), bw)
    for g, r in zip(got, ref):
        assert_close(g, r, 1e-4)


TAPS = {
    "lowpass65": resample.design_lowpass(0.25),
    "lowpass32": resample.design_lowpass(0.2, 32),
    "rrc": np.hanning(15).astype(np.float32),
}


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("taps", sorted(TAPS))
@pytest.mark.parametrize("name", ["conv_full", "conv_same"])
def test_conv_equals_jax(name, taps, complex_):
    x = rows((3, 4096), complex_)
    h = TAPS[taps]
    ref = getattr(jfir, name)(jnp.asarray(x), h)
    got = getattr(fir, name)(torch.from_numpy(x), h)
    assert_close(got, ref, 1e-5)


@pytest.mark.parametrize("k,offset", [(2, 14), (2, 15), (4, 3)])
def test_matched_filter_decimate_equals_jax(k, offset):
    x = rows((2, 3000))
    h = TAPS["rrc"]
    ref = jfir.matched_filter_decimate(jnp.asarray(x), h, k, offset)
    got = fir.matched_filter_decimate(torch.from_numpy(x), h, k, offset)
    assert_close(got, ref, 1e-5)


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("call", ["interp2", "interp3", "decim2", "decim3", "rational2_1",
                                  "rational3_2", "rational2_3"])
def test_integer_resamplers_equal_jax(call, complex_):
    x = rows((3, 3001), complex_)
    if call.startswith("interp"):
        fn, args = "interp", (int(call[-1]),)
    elif call.startswith("decim"):
        fn, args = "decim", (int(call[-1]),)
    else:
        fn, args = "rational", tuple(int(v) for v in call[len("rational"):].split("_"))
    ref = getattr(jres, fn)(jnp.asarray(x), *args)
    got = getattr(resample, fn)(torch.from_numpy(x), *args)
    assert_close(got, ref, 1e-5)


def test_integer_resamplers_take_given_taps():
    x = rows((2, 1000))
    h = resample.design_lowpass(0.2, 31) * 2
    for fn, args in (("interp", (2,)), ("decim", (2,)), ("rational", (3, 2))):
        ref = getattr(jres, fn)(jnp.asarray(x), *args, h)
        got = getattr(resample, fn)(torch.from_numpy(x), *args, h)
        assert_close(got, ref, 1e-5)


@pytest.mark.parametrize("benchmark,deterministic", [(True, False), (False, True)])
def test_conv_keeps_the_callers_cudnn_settings(monkeypatch, benchmark, deterministic):
    """The float32 convolution turns TF32 off for its call and leaves the
    caller's benchmark and deterministic settings as they were."""
    cudnn = torch.backends.cudnn
    seen, conv1d = [], torch.nn.functional.conv1d

    def spy(*a, **k):
        seen.append((cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32))
        return conv1d(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "conv1d", spy)
    with cudnn.flags(enabled=True, benchmark=benchmark, deterministic=deterministic,
                     allow_tf32=True):
        fir.conv_full(torch.from_numpy(rows((2, 256))), TAPS["rrc"])
        assert (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32) == (
            benchmark, deterministic, True)
    assert seen == [(benchmark, deterministic, False)]


# ---------------------------------------------------------------------------
# tests/test_dsp_ops.py's behaviour cases on the port
# ---------------------------------------------------------------------------


class TestAGC:
    def test_block_normalizes_rms(self):
        x = torch.from_numpy(rows((2, 512), seed=0))
        y, gain = agc.agc_block(x)
        rms = torch.sqrt(torch.mean(torch.abs(y) ** 2, dim=-1))
        np.testing.assert_allclose(rms.numpy(), 1.0, rtol=1e-5)

    def test_windowed_tracks_level_change(self):
        x = rows((2048,), seed=1, scale=1.0)
        x[1024:] *= 10.0
        y, gain = agc.agc_windowed(torch.from_numpy(x[None]), window=128)
        y = y.numpy()[0]
        r1 = np.sqrt(np.mean(np.abs(y[512:1024]) ** 2))
        r2 = np.sqrt(np.mean(np.abs(y[1536:]) ** 2))
        assert 0.8 < r1 < 1.2 and 0.8 < r2 < 1.2

    def test_scan_agc_converges(self):
        rng = np.random.default_rng(2)
        x = 5.0 * np.exp(1j * rng.uniform(0, 2 * np.pi, 2000)).astype(np.complex64)
        y, gain = agc.agc_scan(torch.from_numpy(x[None]), alpha=0.05)
        tail = np.abs(y.numpy()[0, -200:])
        np.testing.assert_allclose(tail.mean(), 1.0, rtol=0.05)


class TestNCO:
    def test_mix_down_removes_cfo(self):
        base = rows((1024,), seed=3, scale=1.0)
        cfo, phi = 0.03, 0.5
        x = base * np.exp(1j * (cfo * np.arange(1024) + phi))
        y = nco.mix_down(torch.from_numpy(x[None].astype(np.complex64)),
                         torch.tensor([cfo]), torch.tensor([phi]))
        np.testing.assert_allclose(y.numpy()[0], base, atol=1e-4)

    def test_mix_up_inverts_mix_down(self):
        x = torch.from_numpy(rows((2, 512), seed=6))
        back = nco.mix_up(nco.mix_down(x, 0.07, 1.1), 0.07, 1.1)
        np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-4 * float(x.abs().max()))

    def test_pll_tracks_residual(self):
        rng = np.random.default_rng(4)
        ref = np.exp(1j * rng.integers(0, 4, 600) * np.pi / 2).astype(np.complex64)
        syms = (ref * np.exp(1j * (0.002 * np.arange(600)))).astype(np.complex64)
        out, traj = nco.pll_track(torch.from_numpy(syms[None]), torch.from_numpy(ref[None]), bw=0.05)
        err = np.angle(out.numpy()[0, -100:] * np.conj(ref[-100:]))
        assert np.max(np.abs(err)) < 0.05


class TestResample:
    def test_interp_preserves_signal(self):
        f = 0.05
        x = np.exp(2j * np.pi * f * np.arange(512)).astype(np.complex64)
        y = resample.interp(torch.from_numpy(x[None]), 2).numpy()[0]
        assert len(y) == 1024
        spec = np.abs(np.fft.fft(y[100:900]))
        np.testing.assert_allclose(np.argmax(spec) / 800, f / 2, atol=0.002)

    def test_decim_antialias(self):
        n = np.arange(2048)
        x = (np.exp(2j * np.pi * 0.02 * n) + 0.5 * np.exp(2j * np.pi * 0.4 * n)).astype(np.complex64)
        y = resample.decim(torch.from_numpy(x[None]), 2).numpy()[0]
        spec = np.abs(np.fft.fft(y))
        assert spec[int(0.04 * len(y))] > 10 * spec[int(0.2 * len(y))]

    def test_rational_3_2(self):
        x = np.exp(2j * np.pi * 0.03 * np.arange(600)).astype(np.complex64)
        y = resample.rational(torch.from_numpy(x[None]), 3, 2).numpy()[0]
        assert len(y) == 900
        spec = np.abs(np.fft.fft(y[100:800]))
        np.testing.assert_allclose(np.argmax(spec) / 700, 0.02, atol=0.002)

    def test_arbitrary_ratio(self):
        x = np.cos(2 * np.pi * 0.01 * np.arange(1000)).astype(np.complex64)
        rate = 1.37
        out_len = int(900 * rate)
        y = resample.arbitrary(torch.from_numpy(x[None]), rate, out_len).numpy()[0]
        pos = np.arange(out_len) / rate
        sel = (pos > 20) & (pos < 950)
        np.testing.assert_allclose(y.real[sel], np.cos(2 * np.pi * 0.01 * pos)[sel], atol=5e-3)

    @pytest.mark.parametrize("rate,cplx", [(1.0 + 50e-6, True), (1.0 + 50e-6, False),
                                           (1.0 - 500e-6, True), (1.0 + 500e-6, True)])
    def test_arbitrary_ppm_farrow(self, rate, cplx):
        n = np.arange(4096)
        out_len = 4000
        pos = np.arange(out_len) / rate
        sel = (pos > 30) & (pos < 4000)
        if cplx:
            x = np.exp(2j * np.pi * 0.02 * n).astype(np.complex64)
            want = np.exp(2j * np.pi * 0.02 * pos)
        else:
            x = np.cos(2 * np.pi * 0.02 * n).astype(np.float32)
            want = np.cos(2 * np.pi * 0.02 * pos)
        y = resample.arbitrary(torch.from_numpy(x[None]), rate, out_len).numpy()[0]
        assert y.dtype == x.dtype
        np.testing.assert_allclose(y[sel], want[sel], atol=5e-3)

    @pytest.mark.parametrize("rates", [(1.0 + 50e-6, 1.0 - 20e-6, 1.0 + 5e-6, 1.0 - 50e-6),
                                       (1.25, 0.8)])
    def test_arbitrary_groups_matches_per_rate(self, rates):
        x = rows((8, 2048), seed=3, scale=1.0)
        out_len = 2000
        g = x.shape[0] // len(rates)
        got = resample.arbitrary_groups(torch.from_numpy(x), rates, out_len).numpy()
        want = np.concatenate([
            resample.arbitrary(torch.from_numpy(x[i * g : (i + 1) * g]), r, out_len).numpy()
            for i, r in enumerate(rates)])
        # the shared anti-alias cutoff differs by O(ppm) from each group's own
        np.testing.assert_allclose(got, want, atol=2e-3)
