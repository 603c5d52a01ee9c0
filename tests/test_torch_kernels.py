"""The plain PyTorch version of each of the four kernels against the JAX
function it replaces, run as the JAX package's own tests run it on the CPU
(interpret mode) and through the JAX CPU default backend, on those tests'
cases. The CUDA kernels themselves run only on a GPU; chip_smoke.py holds
each against its plain version there. On CPU tensors the wrappers take the
plain version, so both names are exercised here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.kernels import correlator as jcorr
from liquiddsp_tpu.kernels import extract as jextract
from liquiddsp_tpu.kernels import recover as jrecover
from liquiddsp_tpu.ops.fec import conv as jconv
from liquiddsp_tpu.phy import detector as jdet
from liquiddsp_tpu.phy import frame_spec as jfs
from liquiddsp_tpu.phy import framesync as jsync
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.kernels import correlator as tcorr
from liquiddsp_tpu_torch.kernels import extract as textract
from liquiddsp_tpu_torch.kernels import halo as thalo
from liquiddsp_tpu_torch.kernels import recover as trecover
from liquiddsp_tpu_torch.kernels import viterbi as tviterbi
from liquiddsp_tpu_torch.ops.fec import conv as tconv


def t(a):
    return torch.from_numpy(np.array(a))


# -- correlator -------------------------------------------------------------


def _correlator_case(seed):
    tmpl = jdet.templates_time()
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 3000)) + 1j * rng.standard_normal((2, 3000))).astype(
        np.complex64)
    x[0, 500:628] += 5 * jdet.template()
    x[1, 1700:1828] += 3 * np.asarray(tmpl[3])  # frequency-shifted hit
    return x, tmpl


@pytest.mark.parametrize("backend", ["pallas_interpret", "mm", "xla"])
@pytest.mark.parametrize("seed", [0, 2])
def test_correlator_matches_reference(seed, backend):
    """Tolerances of tests/test_kernels.py: rho2 atol 1e-5 (128-term f32 sums
    in another order), energy rtol 1e-3 atol 1e-2 (the FFT backend takes it
    from a cumulative sum), bins equal and correlations rtol/atol 1e-4 where
    rho2 > 0.04."""
    x, tmpl = _correlator_case(seed)
    a = jcorr.correlate_reduced(jnp.asarray(x), tmpl, backend=backend)
    b = tcorr.correlate_reduced(t(x), tmpl)
    assert b["fbin"].dtype == torch.int32 and b["corr"].dtype == torch.complex64
    np.testing.assert_allclose(b["rho2"].numpy(), np.asarray(a["rho2"]), atol=1e-5)
    np.testing.assert_allclose(
        b["energy"].numpy(), np.asarray(a["energy"]), rtol=1e-3, atol=1e-2)
    peaks = np.asarray(a["rho2"]) > 0.04
    assert peaks.any()
    np.testing.assert_array_equal(b["fbin"].numpy()[peaks], np.asarray(a["fbin"])[peaks])
    np.testing.assert_allclose(
        b["corr"].numpy()[peaks], np.asarray(a["corr"])[peaks], rtol=1e-4, atol=1e-4)


def test_correlator_first_maximum_wins_and_tail_is_zero_padded():
    x = np.zeros((1, 300), np.complex64)
    x[0, 100:228] = jdet.template()
    tmpl = np.stack([jdet.template()] * 5)  # five equal bins tie everywhere
    b = tcorr.correlate_reduced_ref(t(x), tmpl)
    assert int(b["fbin"].max()) == 0
    assert b["rho2"].shape == (1, 300)
    np.testing.assert_allclose(float(b["rho2"][0, 100]), 1.0, atol=1e-5)
    np.testing.assert_allclose(float(b["energy"][0, 299]), abs(x[0, 299]) ** 2, atol=1e-7)


# -- extract ----------------------------------------------------------------


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_extract_matches_reference_exactly(backend):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 2500)) + 1j * rng.standard_normal((3, 2500))).astype(
        np.complex64)
    starts = rng.integers(0, 2499, (3, 7)).astype(np.int32)
    n = 300
    a = np.asarray(jextract.extract_windows(jnp.asarray(x), jnp.asarray(starts), n,
                                            backend=backend))
    b = textract.extract_windows(t(x), t(starts), n)
    assert b.dtype == torch.complex64
    np.testing.assert_array_equal(a, b.numpy())
    wr, wi = textract.extract_windows(t(x), t(starts), n, return_planes=True)
    assert wr.dtype == torch.float32 and wr.shape == (3, 7, n)
    np.testing.assert_array_equal(wr.numpy(), a.real)
    np.testing.assert_array_equal(wi.numpy(), a.imag)


def test_extract_edge_start_reads_zero_pad():
    x = np.ones((1, 200), np.complex64)
    starts = np.asarray([[150]], np.int32)
    a = np.asarray(jextract.extract_windows(jnp.asarray(x), jnp.asarray(starts), 128,
                                            backend="pallas_interpret"))
    w = textract.extract_windows(t(x), t(starts), 128).numpy()
    np.testing.assert_array_equal(a, w)
    assert w[0, 0, :50].real.all() and not w[0, 0, 50:].any()


# -- recover ----------------------------------------------------------------


def _recover_case(seed, b=2, k=3, n_syms=200):
    rng = np.random.default_rng(seed)
    n_samples = jfs.K_SAMP * n_syms + jfs.PULSE_TAIL
    win = (rng.standard_normal((b, k, n_samples))
           + 1j * rng.standard_normal((b, k, n_samples))).astype(np.complex64)
    det = jdet.Detections(
        mask=jnp.ones((b, k), bool),
        start=jnp.zeros((b, k), jnp.int32),
        rho=jnp.ones((b, k), jnp.float32),
        gamma=jnp.asarray(rng.uniform(0.5, 2.0, (b, k)), jnp.float32),
        dphi=jnp.asarray(rng.uniform(-0.05, 0.05, (b, k)), jnp.float32),
        phi=jnp.asarray(rng.uniform(-np.pi, np.pi, (b, k)), jnp.float32),
        tau=jnp.asarray(rng.uniform(-0.5, 0.5, (b, k)), jnp.float32),
    )
    return win, det, n_syms


@pytest.mark.parametrize("reference", ["fused_interpret", "xla"])
@pytest.mark.parametrize("seed", [0, 1])
def test_recover_matches_reference(seed, reference):
    """atol 2e-4 * max|ref| as in tests/test_kernels.py: float32 phase
    dphi*m + phi (the XLA path builds it as a coarse x fine product) and
    30-term sums in another order."""
    win, det, n_syms = _recover_case(seed)
    taps = np.asarray(jsync._candidate_taps30(det, True))
    if reference == "xla":
        ref = np.asarray(jsync.symbols_from_windows(jnp.asarray(win), det, n_syms))
    else:
        nd = -(-win.shape[-1] // 128) * 128
        wp = np.zeros(win.shape[:-1] + (nd,), np.complex64)
        wp[..., : win.shape[-1]] = win
        ref = np.asarray(jrecover.recover_symbols_planes(
            jnp.asarray(wp.real), jnp.asarray(wp.imag), det.dphi, det.phi, det.gamma,
            jnp.asarray(taps), n_syms, interpret=True))
    got = trecover.recover_symbols_planes(
        t(win.real), t(win.imag), t(np.asarray(det.dphi)), t(np.asarray(det.phi)),
        t(np.asarray(det.gamma)), t(taps), n_syms)
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4 * np.abs(ref).max())


def test_recover_rejects_short_window():
    z = torch.zeros((1, 1, 100))
    s = torch.zeros((1, 1))
    with pytest.raises(ValueError):
        trecover.recover_symbols_planes(z, z, s, s, s, torch.zeros((1, 1, 30)), 50)


# -- viterbi ----------------------------------------------------------------


def _llrs(kind, inner, nbits, seed, batch=4):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, nbits)).astype(np.int8)
    coded = np.stack([jconv.encode_host(b, inner) for b in bits])
    llr = (1.0 - 2.0 * coded).astype(np.float32)
    if kind == "noisy":
        llr = llr + 0.6 * rng.standard_normal(llr.shape).astype(np.float32)
    elif kind == "zero":
        llr = np.zeros_like(llr)
    elif kind == "hard_errors":
        flip = rng.random(llr.shape) < 0.03
        llr = np.where(flip, -llr, llr)
    return bits, llr


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("kind", ["noisy", "hard", "hard_errors", "zero"])
@pytest.mark.parametrize("inner", [1, 3, 5])
def test_viterbi_bit_exact(inner, kind, backend):
    """Bit for bit, ties included (hard decisions and erasures tie often).
    122 message bits give 128 trellis steps, so the interpret-mode kernel,
    which pads to a multiple of 8 steps, sees the same trellis."""
    nbits = 122
    bits, llr = _llrs(kind, inner, nbits, seed=31 + inner)
    ref = np.asarray(jconv.decode(jnp.asarray(llr), nbits, inner, backend=backend))
    got = tconv.decode(t(llr), nbits, inner)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    if kind == "hard":
        np.testing.assert_array_equal(got.numpy(), bits)


def test_viterbi_bench_trellis_and_wrapper():
    """The coded receiver config's trellis (1080 + 6 steps), through the
    kernel's wrapper on a CPU tensor, against the scan reference."""
    nbits = 1080
    _, llr = _llrs("noisy", 1, nbits, seed=5, batch=3)
    lam = t(llr.reshape(3, nbits + 6, 2))
    got = tviterbi.viterbi(lam)
    np.testing.assert_array_equal(got.numpy(), tviterbi.viterbi_ref(lam).numpy())
    ref = np.asarray(jconv.decode(jnp.asarray(llr), nbits, 1, backend="xla"))
    np.testing.assert_array_equal(got.numpy()[:, :nbits], ref)


# -- wrappers ---------------------------------------------------------------


def test_wrappers_refuse_wrong_tensors_and_count_no_cpu_launch():
    before = dict(_cuda.LAUNCHES)
    x = torch.zeros((1, 256), dtype=torch.complex64)
    tcorr.correlate_reduced(x, jdet.templates_time())
    textract.extract_windows(x, torch.zeros((1, 1), dtype=torch.int32), 16)
    thalo.halo_windows(x, 2, 16)
    assert _cuda.LAUNCHES == before  # the plain versions are not launches
    with pytest.raises(ValueError):
        _cuda.check_cuda("x", x, torch.complex64, (1, 256))  # a CPU tensor
    assert set(_cuda.LAUNCHES) == {"correlator", "extract", "recover", "viterbi", "halo", "halo_wait"}
    assert set(_cuda.SOURCES) == {p.name for p in _cuda.CSRC.glob("*.cu")}


def test_halo_order_takes_its_plain_version_on_the_cpu():
    """On CPU flags halo_order is its plain version: the store, then a wait
    that holds; a wait that cannot hold (nothing else writes a CPU flag)
    raises, as does a call with no flag; no launch is counted."""
    before = dict(_cuda.LAUNCHES)
    flags = torch.zeros(3, dtype=torch.int64)
    flags[1] = 4
    thalo.halo_order(flags[0], 7, flags[1], 4)
    thalo.halo_order(None, 0, flags[0], 7)
    assert flags.tolist() == [7, 4, 0]
    with pytest.raises(RuntimeError):
        thalo.halo_order(flags[2], 1, flags[1], 5)
    with pytest.raises(ValueError):
        thalo.halo_order(None, 0, None, 0)
    assert _cuda.LAUNCHES == before


def test_c_interfaces_match_their_sources():
    """Every C entry point of ``_ARGTYPES`` is defined in a source with as many
    parameters as the wrapper passes, the stream last."""
    import re
    text = "".join((_cuda.CSRC / name).read_text() for name in _cuda.SOURCES)
    for fn, argtypes in _cuda._ARGTYPES.items():
        m = re.search(r'extern "C" int %s\(([^)]*)\)' % fn, text)
        assert m is not None, fn
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), (fn, params)
        assert params[-1] == "void* stream"
        for p, a in zip(params, argtypes):
            is_pointer = "*" in p
            assert is_pointer == (a is _cuda._vp), (fn, p)


def test_viterbi_and_recover_scratch_follow_the_designs():
    """The wrappers hand the kernels what the designs' index functions say:
    a decision row of whole 5-step periods, the per-lane sign table, the
    recover tile; on the CPU they take the plain versions and count nothing."""
    before = dict(_cuda.LAUNCHES)
    lam = torch.zeros((2, 13, 2))
    assert tviterbi.viterbi(lam).shape == (2, 13)
    assert tviterbi.warp_signs().shape == (tviterbi.PHASES, tviterbi.LANES, 8)
    z = torch.zeros((1, 2, 38))
    s = torch.ones((1, 2))
    y = trecover.recover_symbols_planes(z, z, s, s, s, torch.zeros((1, 2, 30)), 5)
    assert y.shape == (1, 2, 5) and y.dtype == torch.complex64
    assert trecover.recover_tile(5) == (8, 1)
    assert _cuda.LAUNCHES == before
