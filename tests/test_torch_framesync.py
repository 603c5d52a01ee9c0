"""The block receiver of the PyTorch port against the JAX package, as a whole
and stage by stage, for both receiver configs: QPSK uncoded at 20 dB and
QPSK + V27 + Golay(24,12) at 10 dB, on frames with CFO, carrier phase,
fractional delay, gain and AWGN. Small shapes (B = 2, T = 8192)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.phy import frame_spec as jfs
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu.phy import framesync as jsync
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.phy import framesync as tsync
from liquiddsp_tpu_torch.phy.detector import Detections
from liquiddsp_tpu_torch.phy.tables import phy_tables

CASES = {"uncoded": ((1, 0, 0, 64), 20.0), "coded": ((1, 1, 1, 64), 10.0)}
B, T = 2, 8192
DET_FIELDS = ("mask", "start", "rho", "gamma", "dphi", "phi", "tau")


def t(a):
    return torch.from_numpy(np.array(a))


def frac_delay(x, d):
    """Delay rows of x by d samples (|d| < 1) with a windowed-sinc FIR."""
    n = np.arange(-24, 25)
    h = np.sinc(n - d) * np.hamming(len(n))
    h /= h.sum()
    return np.stack([np.convolve(r, h, mode="same") for r in x])


class Case:
    def __init__(self, name):
        cfg, snr_db = CASES[name]
        self.jcfg, self.tcfg = JFrameConfig(*cfg), FrameConfig(*cfg)
        rng = np.random.default_rng(len(name))
        self.payload = rng.integers(0, 256, (B, cfg[3]), dtype=np.uint8)
        frames = np.asarray(jframegen.framegen(jnp.asarray(self.payload), self.jcfg))
        f = frames.shape[1]
        x = np.zeros((B, T), np.complex128)
        pos, n = 137, np.arange(f)
        self.starts = []
        while pos + f + 40 <= T:
            imp = np.exp(1j * (rng.uniform(-0.02, 0.02) * n + rng.uniform(-3, 3)))
            x[:, pos : pos + f] += rng.uniform(0.7, 1.5) * frames * imp
            self.starts.append(pos)
            pos += f + int(rng.integers(200, 700))
        x = frac_delay(x, rng.uniform(-0.45, 0.45))
        p_sig = np.mean(np.abs(frames) ** 2)
        sigma = np.sqrt(p_sig / (2 * 10 ** (snr_db / 10)))
        x += sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
        self.x = x.astype(np.complex64)
        self.k = len(self.starts) + 2
        self.n_syms = jfs.FrameSpec(self.jcfg).frame_syms
        self.tables = phy_tables(self.tcfg, "cpu")
        # one compile of the reference per config
        self.ref = jax.jit(
            functools.partial(jsync.framesync_fixed, cfg=self.jcfg, max_frames=self.k)
        )(jnp.asarray(self.x))
        self.got = tsync.framesync_fixed(t(self.x), self.tcfg, self.k, device="cpu")


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return Case(request.param)


def test_frames_found_where_they_were_put(case):
    mask = case.got.mask.numpy()
    assert mask.sum() == B * len(case.starts)
    found = sorted(case.got.start.numpy()[0][mask[0]].tolist())
    assert np.max(np.abs(np.array(found) - np.array(case.starts))) <= 1


@pytest.mark.parametrize(
    "field", ["mask", "start", "header_valid", "payload_valid", "modulation",
              "inner_code", "outer_code", "payload_len", "header_user"])
def test_discrete_fields_identical(case, field):
    a, b = np.asarray(getattr(case.ref, field)), getattr(case.got, field).numpy()
    assert a.dtype == b.dtype, field
    if field in ("mask", "start"):
        np.testing.assert_array_equal(a, b)
    else:  # unmasked slots decode noise: compare the detected ones
        m = np.asarray(case.ref.mask)
        np.testing.assert_array_equal(a[m], b[m])


def test_payload_bytes_identical_and_as_sent(case):
    valid = np.asarray(case.ref.payload_valid)
    assert valid.sum() == B * len(case.starts)  # every frame decodes at this SNR
    ref, got = np.asarray(case.ref.payload), case.got.payload.numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(ref[valid], got[valid])
    for b in range(B):
        assert (got[b][valid[b]] == case.payload[b]).all()
    # header fields say what was sent
    cfg = case.tcfg
    for name, want in (("modulation", cfg.modulation), ("inner_code", cfg.inner_code),
                       ("outer_code", cfg.outer_code), ("payload_len", cfg.payload_len)):
        assert (getattr(case.got, name).numpy()[valid] == want).all()


def test_symbols_close(case):
    """2e-3 * max|symbols|: the chain of float32 stages (correlation,
    recovery, two equalizer solves, carrier fits) rounds differently."""
    m = np.asarray(case.ref.mask)
    ref, got = np.asarray(case.ref.symbols), case.got.symbols.numpy()
    assert got.dtype == np.complex64 and got.shape == ref.shape
    np.testing.assert_allclose(got[m], ref[m], atol=2e-3 * np.abs(ref[m]).max())


@pytest.mark.parametrize("field,atol", [("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6)])
def test_stats_close(case, field, atol):
    """evm and rssi are in dB (evm follows the symbols' 1e-3 relative
    differences); cfo is in rad/sample."""
    m = np.asarray(case.ref.mask)
    np.testing.assert_allclose(
        getattr(case.got, field).numpy()[m], np.asarray(getattr(case.ref, field))[m], atol=atol)


def test_to_numpy_has_every_field(case):
    d = case.got.to_numpy()
    assert set(d) == {f for f in case.got.__dataclass_fields__}
    assert d["start"].dtype == np.int32 and d["payload"].dtype == np.uint8


# -- stage by stage, on the reference's own detections ------------------------


@pytest.fixture(scope="module")
def staged(case):
    """The reference's detections handed to both packages' later stages."""
    jdet_ = jsync.detect(jnp.asarray(case.x), case.k, fine=False)
    sc = jax.jit(functools.partial(
        jsync.sync_common, n_syms=case.n_syms, max_frames=case.k, return_hdr_ref=True)
    )(jnp.asarray(case.x), det_override=jdet_)
    det = Detections.from_numpy({f: np.asarray(getattr(jdet_, f)) for f in DET_FIELDS}, "cpu")
    det2, syms0 = tsync.recover_candidates(t(case.x), det, case.n_syms, case.tables)
    out = tsync.sync_symbols(syms0, case.tables)
    return sc, det2, out


def test_stage_fine_cfo_on_reference_detections(case, staged):
    sc, det2, _ = staged
    m = np.asarray(sc[0].mask)
    np.testing.assert_allclose(det2.dphi.numpy()[m], np.asarray(sc[0].dphi)[m], atol=1e-6)


def test_stage_sync_symbols_on_reference_detections(case, staged):
    sc, _, (syms, fields, evm_lin, hdr_ref) = staged
    m = np.asarray(sc[0].mask)
    ref = np.asarray(sc[1])
    np.testing.assert_allclose(syms.numpy()[m], ref[m], atol=2e-3 * np.abs(ref[m]).max())
    for a, b in zip(sc[2], fields):
        np.testing.assert_array_equal(np.asarray(a)[m], b.numpy()[m])
    np.testing.assert_allclose(evm_lin.numpy()[m], np.asarray(sc[3])[m], rtol=5e-3)
    np.testing.assert_array_equal(hdr_ref.numpy()[m], np.asarray(sc[-1])[m])


def test_stage_payload_decode_on_reference_symbols(case, staged):
    """The reference's equalized symbols through both payload back-ends."""
    sc = staged[0]
    rng = np.random.default_rng(9)
    shape = np.asarray(sc[3]).shape
    anchor = rng.uniform(-0.05, 0.05, shape).astype(np.float32)
    slope = rng.uniform(-1e-4, 1e-4, shape).astype(np.float32)
    pj, okj = jsync.decode_payload_symbols(
        sc[1], case.jcfg, noise_var=sc[3], anchor=jnp.asarray(anchor),
        anchor_slope=jnp.asarray(slope))
    pt, okt = tsync.decode_payload_symbols(
        t(np.asarray(sc[1])), case.tcfg, noise_var=t(np.asarray(sc[3])), anchor=t(anchor),
        anchor_slope=t(slope), tables=case.tables)
    m = np.asarray(sc[0].mask)
    np.testing.assert_array_equal(np.asarray(okj)[m], okt.numpy()[m])
    assert okt.numpy()[m].all()
    np.testing.assert_array_equal(np.asarray(pj)[m], pt.numpy()[m])
