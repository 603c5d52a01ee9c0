"""ops/resample.arbitrary of the PyTorch port against the JAX package: the
low-rank Farrow path at +-50 ppm (the sample-clock offsets the SFO tests
stretch frames by) and the gather path at rates far from 1, on complex and
real rows; and the numpy tables it is built from (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.ops import resample as jres
from liquiddsp_tpu_torch.ops import resample as tres


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's tests: the suite runs in several
    worker processes at once, and torch's default of a thread a core
    oversubscribes them (alone, these tests run as fast on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = 4096


def rows(complex_=True):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, T)) + 1j * rng.standard_normal((3, T))
    return (x if complex_ else x.real).astype(np.complex64 if complex_ else np.float32)


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("rate,out_len", [(1 / (1 + 50e-6), T), (1 / (1 - 50e-6), T),
                                          (1 / (1 + 500e-6), T), (0.73, 2900), (1.3, 5000)])
def test_arbitrary_equals_jax(rate, out_len, complex_):
    """Within 1e-5 x max|ref|: the same float32 filters, sums in another order."""
    x = rows(complex_)
    ref = np.asarray(jres.arbitrary(jnp.asarray(x), rate, out_len))
    got = tres.arbitrary(torch.from_numpy(x), rate, out_len)
    assert got.dtype == (torch.complex64 if complex_ else torch.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())


def test_arbitrary_delays_a_tone():
    """y[i] = x(i / rate): a slow tone comes out at the stretched positions."""
    n = np.arange(T)
    f = 0.01
    x = np.exp(2j * np.pi * f * n).astype(np.complex64)[None]
    rate = 1 / (1 + 50e-6)
    y = tres.arbitrary(torch.from_numpy(x), rate, T).numpy()[0]
    want = np.exp(2j * np.pi * f * n / rate)
    np.testing.assert_allclose(y[64:-64], want[64:-64], atol=1e-3)


def test_tables_equal_jax():
    np.testing.assert_array_equal(tres.design_lowpass(0.25), jres.design_lowpass(0.25))
    np.testing.assert_array_equal(tres._frac_bank(32, 33, 0.5), jres._frac_bank(32, 33, 0.5))
    mu = np.linspace(0, 0.99, 17)
    np.testing.assert_array_equal(tres._bank_rows(mu, 33, 0.5), jres._bank_rows(mu, 33, 0.5))
    h_t, r_t = tres._bank_lowrank(33, 0.5)
    h_j, r_j = jres._bank_lowrank(33, 0.5)
    np.testing.assert_array_equal(h_t, h_j)
    assert r_t == r_j < 1e-3
    pt = tres._lowrank_plan(1 / (1 + 50e-6), T, 33, 0.5, h_t)
    pj = jres._lowrank_plan(1 / (1 + 50e-6), T, 33, 0.5, h_j)
    np.testing.assert_array_equal(pt[0], pj[0])
    np.testing.assert_array_equal(pt[1], pj[1])
    assert pt[2:] == pj[2:]
