"""ops/resample.arbitrary and arbitrary_groups of the PyTorch port against
the JAX package: the low-rank Farrow path at +-50 ppm (the sample-clock
offsets the SFO tests stretch frames by), the gather path at rates far from
1 and the stencil fallback (forced), on complex and real rows; the groups of
bench.py's resampled configuration in float32 and bf16; the two defects of
the JAX package's arbitrary_groups not copied; and the numpy tables (exact)."""

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


# ---------------------------------------------------------------------------
# arbitrary_groups: BASELINE config 3's per-channel-group resampler
# ---------------------------------------------------------------------------

BENCH_RATES = tuple(1.0 + p * 1e-6 for p in (-50.0, -20.0, 20.0, 50.0))  # bench.py:222


def group_rows(n_rows=4, t=8192, complex_=True, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, t)) + 1j * rng.standard_normal((n_rows, t))
    return (x if complex_ else x.real).astype(np.complex64 if complex_ else np.float32)


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("rates", [BENCH_RATES, (1.25, 0.8)], ids=["bench_ppm", "fallback"])
def test_arbitrary_groups_equals_jax(rates, complex_):
    """float32: within 1e-5 x max|ref|, the shared path (the bench's four ppm
    groups) and the per-group fallback (rates far from 1)."""
    x = group_rows(t=4096, complex_=complex_)
    ref = np.asarray(jres.arbitrary_groups(jnp.asarray(x), rates, 4000))
    got = tres.arbitrary_groups(torch.from_numpy(x), rates, 4000)
    assert got.dtype == (torch.complex64 if complex_ else torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("rank", [4, 5])
def test_arbitrary_groups_bf16_equals_jax(rank):
    """bf16 operands and planes, the combine in float32 (bench.py's setting
    is rank 4): within 1e-2 x max|ref| and under 5e-3 RMS relative of the
    JAX package's own bf16 output."""
    x = group_rows()
    ref = np.asarray(jres.arbitrary_groups(jnp.asarray(x), BENCH_RATES, 8192,
                                           compute_dtype=jnp.bfloat16, rank=rank))
    got = tres.arbitrary_groups(torch.from_numpy(x), BENCH_RATES, 8192,
                                compute_dtype=torch.bfloat16, rank=rank).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, atol=1e-2 * np.abs(ref).max())
    rms = np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2))
    assert rms < 5e-3, rms
    # and bf16 is a quantisation of the float32 result, not another function
    f32 = tres.arbitrary_groups(torch.from_numpy(x), BENCH_RATES, 8192, rank=rank).numpy()
    assert np.sqrt(np.mean(np.abs(got - f32) ** 2) / np.mean(np.abs(f32) ** 2)) < 1e-2


@pytest.fixture
def sharp_bank(monkeypatch):
    """Both packages' bank factorisation reports a residual over every gate,
    so arbitrary takes its stencil fallback (the JAX package's files are not
    edited: its module attribute is replaced for the test)."""
    for mod in (jres, tres):
        real = mod._bank_lowrank
        monkeypatch.setattr(mod, "_bank_lowrank", lambda *a, real=real, **k: (real(*a, **k)[0], 1.0))


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("rate", [1 / (1 + 500e-6), 1 + 2e-3])
def test_stencil_fallback_equals_jax(sharp_bank, rate, complex_):
    x = rows(complex_)
    ref = np.asarray(jres.arbitrary(jnp.asarray(x), rate, T))
    got = tres.arbitrary(torch.from_numpy(x), rate, T)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    # the nearest-of-32-phase stencil, not the exact-delay low-rank path
    lowrank = tres._lowrank_apply(torch.from_numpy(x), [rate], T, 33, 0.5 * min(1.0, rate), 5)
    assert np.abs(got.numpy() - lowrank.numpy()).max() > 1e-4 * np.abs(ref).max()


def test_stencil_fallback_of_groups_equals_jax(sharp_bank):
    x = group_rows(t=2048)
    ref = np.asarray(jres.arbitrary_groups(jnp.asarray(x), BENCH_RATES, 2000))
    got = tres.arbitrary_groups(torch.from_numpy(x), BENCH_RATES, 2000).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_groups_one_dimensional_input():
    """1-D input is one channel: one rate resamples it, several raise (the
    JAX package returns a wrong result there, ROADMAP.md C)."""
    x = group_rows(1)[0]
    got = tres.arbitrary_groups(torch.from_numpy(x), BENCH_RATES[:1], 8000).numpy()
    want = tres.arbitrary(torch.from_numpy(x), BENCH_RATES[0], 8000).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="1-D"):
        tres.arbitrary_groups(torch.from_numpy(x), BENCH_RATES, 8000)
    with pytest.raises(ValueError, match="not divisible"):
        tres.arbitrary_groups(torch.from_numpy(group_rows(6)), BENCH_RATES, 8000)


def test_groups_fallback_honours_compute_dtype():
    """Rates beyond 1e-3 of unity fall back to per-group arbitrary, which
    keeps the caller's compute_dtype (the JAX package drops it, ROADMAP.md C)."""
    x = group_rows()
    rates = (1 + 2e-3, 1 - 1e-3)
    got = tres.arbitrary_groups(torch.from_numpy(x), rates, 8000, compute_dtype=torch.bfloat16)
    want = torch.cat([tres.arbitrary(torch.from_numpy(x[2 * i : 2 * i + 2]), r, 8000,
                                     compute_dtype=torch.bfloat16) for i, r in enumerate(rates)])
    assert torch.equal(got, want)
    f32 = tres.arbitrary_groups(torch.from_numpy(x), rates, 8000)
    assert not torch.equal(got, f32)


def test_device_plans_are_bounded():
    """The plans' device copies live in a cache as bounded as the plans: many
    distinct rates do not grow device memory without end."""
    x = torch.from_numpy(group_rows(1, t=600))
    tres._device_plan.cache_clear()
    for k in range(70):
        tres.arbitrary_groups(x, (1 + (k + 1) * 1e-6,), 512)
    assert tres._device_plan.cache_info().currsize == 64
    assert tres._cached_plan.cache_info().maxsize == 64
