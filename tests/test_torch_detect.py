"""detect() of the PyTorch port against the JAX package on the same streams.

mask and start exact; gamma rtol 1e-4 (float32 window energy in another
summation order); tau atol 0.06 (a ratio of rho2 differences near the peak,
as tests/test_kernels.py allows); dphi, phi, rho atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.phy import detector as jdet
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu_torch.phy import detector as tdet


def make_stream(seed, cfg=(1, 0, 0, 64), b=2, t_len=8192, noise=0.05):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (b, cfg[3]), dtype=np.uint8)
    frames = np.asarray(jframegen.framegen(jnp.asarray(payload), JFrameConfig(*cfg)))
    f = frames.shape[1]
    x = np.zeros((b, t_len), np.complex64)
    pos, starts = 211, []
    n = np.arange(f)
    while pos + f <= t_len:
        cfo = rng.uniform(-0.02, 0.02)
        gain = rng.uniform(0.5, 2.0)
        x[:, pos : pos + f] += (gain * frames * np.exp(1j * (cfo * n + rng.uniform(-3, 3)))
                                ).astype(np.complex64)
        starts.append(pos)
        pos += f + int(rng.integers(300, 900))
    x += (noise * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
          ).astype(np.complex64)
    return x, starts


@pytest.mark.parametrize("backend", ["auto", "pallas_interpret"])
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("fine", [True, False])
def test_detect_matches_reference(fine, seed, backend):
    x, starts = make_stream(seed)
    k = len(starts) + 2
    a = jdet.detect(jnp.asarray(x), k, backend=backend, fine=fine)
    b = tdet.detect(torch.from_numpy(x), k, fine=fine, device="cpu")
    mask = np.asarray(a.mask)
    assert mask.sum() == 2 * len(starts)
    assert b.start.dtype == torch.int32 and b.mask.dtype == torch.bool
    np.testing.assert_array_equal(mask, b.mask.numpy())
    # masked slots too: ties among non-peak blocks go to the lowest index
    np.testing.assert_array_equal(np.asarray(a.start), b.start.numpy())
    assert sorted(np.asarray(a.start)[0][mask[0]].tolist()) == starts
    g = lambda name: (np.asarray(getattr(a, name))[mask], getattr(b, name).numpy()[mask])
    np.testing.assert_allclose(g("gamma")[1], g("gamma")[0], rtol=1e-4)
    np.testing.assert_allclose(g("tau")[1], g("tau")[0], atol=0.06)
    for name in ("dphi", "phi", "rho"):
        np.testing.assert_allclose(g(name)[1], g(name)[0], atol=1e-4, err_msg=name)


def make_close_preambles(seed, b=2, t_len=4096, noise=0.05):
    """Bare preambles 140-250 samples apart, closer than 2 x 128."""
    rng = np.random.default_rng(seed)
    tmpl = np.asarray(jdet.template())
    n = np.arange(len(tmpl))
    x = np.zeros((b, t_len), np.complex64)
    pos, starts = 97, []
    while pos + len(tmpl) <= t_len:
        for row in range(b):
            x[row, pos : pos + len(tmpl)] += (rng.uniform(0.5, 2.0) * tmpl * np.exp(
                1j * (rng.uniform(-0.02, 0.02) * n + rng.uniform(-3, 3)))).astype(np.complex64)
        starts.append(pos)
        pos += int(rng.integers(140, 251))
    x += (noise * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
          ).astype(np.complex64)
    return x, starts


@pytest.mark.parametrize("min_spacing", [64, 256])
def test_detect_min_spacing_matches_reference(min_spacing):
    """The suppression block of ``min_spacing`` samples: starts, masks and
    the peak count exact, the floats at test_detect_matches_reference's
    tolerances. At 64 every preamble is found; at 256 close ones are
    suppressed."""
    x, starts = make_close_preambles(5)
    k = min(len(starts) + 2, x.shape[1] // min_spacing)  # top-K over the blocks
    a, na = jdet.detect(jnp.asarray(x), k, min_spacing=min_spacing, return_count=True)
    b, nb = tdet.detect(torch.from_numpy(x), k, min_spacing=min_spacing, return_count=True,
                        device="cpu")
    mask = np.asarray(a.mask)
    np.testing.assert_array_equal(mask, b.mask.numpy())
    np.testing.assert_array_equal(np.asarray(a.start), b.start.numpy())
    np.testing.assert_array_equal(np.asarray(na), nb.numpy())
    found = sorted(np.asarray(a.start)[0][mask[0]].tolist())
    if min_spacing == 64:
        assert found == starts
    else:
        assert 0 < len(found) < len(starts)
    g = lambda name: (np.asarray(getattr(a, name))[mask], getattr(b, name).numpy()[mask])
    np.testing.assert_allclose(g("gamma")[1], g("gamma")[0], rtol=1e-4)
    np.testing.assert_allclose(g("tau")[1], g("tau")[0], atol=0.06)
    for name in ("dphi", "phi", "rho"):
        np.testing.assert_allclose(g(name)[1], g(name)[0], atol=1e-4, err_msg=name)


def test_detections_from_numpy_roundtrip():
    x, starts = make_stream(3, b=1, t_len=4096)
    a = jdet.detect(jnp.asarray(x), 3)
    d = {f: np.asarray(getattr(a, f)) for f in ("mask", "start", "rho", "gamma", "dphi", "phi", "tau")}
    b = tdet.Detections.from_numpy(d, device="cpu")
    for f, v in d.items():
        np.testing.assert_array_equal(getattr(b, f).numpy(), v)
    assert b.start.dtype == torch.int32


def test_empty_stream_detects_nothing():
    b = tdet.detect(torch.zeros((2, 2048), dtype=torch.complex64), 4, device="cpu")
    assert not bool(b.mask.any())
    assert b.start.shape == (2, 4)
