"""The port's config-space loopback (liquiddsp_tpu_torch/config_space.py,
the counterpart of bench/config_space.py) on the CPU: max_frame_spec equal
to the JAX package's, the reference's samples drawn, and every modulation,
inner code and outer code decoded through FlexRx against what was sent."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.phy import frame_spec as jfs
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu_torch import config_space as cs
from liquiddsp_tpu_torch.phy import frame_spec as tfs
from liquiddsp_tpu_torch.runtime.blocks import FlexRx


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's tests: the suite runs in several
    worker processes at once, and torch's default of a thread a core
    oversubscribes them (alone, these tests run as fast on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# 16 configs that together cover the 11 modulations, 7 inner codes and 8 outer codes
COVER = [(m, m % 7, (3 * m) % 8) for m in range(11)] + [
    (0, 6, 1), (1, 5, 2), (2, 4, 4), (3, 3, 6), (4, 2, 7)]


@pytest.mark.parametrize("payload_len", [16, 24, 32, 40, 48, 64, 128, 200, 256])
def test_max_frame_spec_equals_jax(payload_len):
    a, b = jfs.max_frame_spec(payload_len), tfs.max_frame_spec(payload_len)
    assert (a.cfg.modulation, a.cfg.inner_code, a.cfg.outer_code) == (
        b.cfg.modulation, b.cfg.inner_code, b.cfg.outer_code)
    assert (a.frame_syms, a.frame_samples) == (b.frame_syms, b.frame_samples)
    assert b.frame_syms == max(
        tfs.FrameSpec(tfs.FrameConfig(m, i, o, payload_len)).frame_syms
        for m in range(11) for i in range(7) for o in range(8))


def test_max_frame_spec_sizes_the_sfo_path():
    """FlexRx's default buffer (payload 64) and the long-frame sweep's
    (payload 256) are past SFO_AUTO_SYMS; the config sweep's (32) is not."""
    from liquiddsp_tpu_torch.phy.framesync import SFO_AUTO_SYMS

    assert tfs.max_frame_spec(64).frame_syms == 2416 >= SFO_AUTO_SYMS
    assert tfs.max_frame_spec(256).frame_syms == 8560
    assert tfs.max_frame_spec(32).frame_syms == 1408 < SFO_AUTO_SYMS


def test_every_code_and_modulation_decodes_what_was_sent():
    assert {c[0] for c in COVER} == set(range(11))
    assert {c[1] for c in COVER} == set(range(7)) and {c[2] for c in COVER} == set(range(8))
    res = cs.config_space_loopback(payload_len=16, shards=2, configs=COVER, device="cpu")
    assert res == {f"{m}_{i}_{o}": True for m, i, o in COVER}


def test_config_space_loopback_one_modulation():
    res = cs.config_space_loopback(payload_len=16, mods=[3], device="cpu")
    assert len(res) == 56 and all(res.values()), [k for k, v in res.items() if not v]
    assert set(res) == {f"3_{i}_{o}" for i in range(7) for o in range(8)}


def test_frame_outcomes_counts_false_passes():
    cfgs = [(1, 0, 0)]
    x, payloads = cs.loopback_block(cfgs, 16, 2, 2 * cs.slot_samples(16) + cs.LEAD,
                                    np.random.default_rng(0), "cpu")
    infos = FlexRx(max_payload_len=16, max_frames_per_block=4, device="cpu").work(x)
    ok, false = cs.frame_outcomes(infos, cfgs, payloads, 16)
    assert ok.all() and not false.any()
    wrong = dict(infos[1], payload=infos[1]["payload"] ^ 1)
    ok, false = cs.frame_outcomes([infos[0], wrong, infos[0]], cfgs, payloads, 16)
    assert ok.tolist() == [[True, False]] and false.tolist() == [[1, 1]]


@pytest.mark.parametrize("configs", [[(0, 0, 0), (8, 1, 3), (10, 6, 7)], [(4, 2, 5)]])
def test_loopback_block_draws_the_reference_samples(configs):
    """bench/config_space.py's block, written out with the JAX framegen:
    per channel the payloads, then the noise's real and imaginary parts from
    one numpy generator. Payloads exact, samples within 1e-5 x max (the
    framegen's float32 sums)."""
    plen, nf = 32, 2
    slot = cs.slot_samples(plen)
    t_block = nf * slot + cs.LEAD
    rng = np.random.default_rng(0)
    x = np.zeros((len(configs), t_block), dtype=np.complex64)
    sent = []
    for ch, (m, i, o) in enumerate(configs):
        payloads = rng.integers(0, 256, (nf, plen), dtype=np.uint8)
        frames = np.asarray(jframegen.framegen(jnp.asarray(payloads), JFrameConfig(m, i, o, plen)))
        for j in range(nf):
            s = cs.LEAD + j * slot
            x[ch, s : s + frames.shape[1]] = frames[j]
        snr_db = 18.0 + 2.0 * JFrameConfig(m, i, o, plen).bps
        sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10)))
        x[ch] += sigma * (rng.standard_normal(t_block)
                          + 1j * rng.standard_normal(t_block)).astype(np.complex64)
        sent.append(payloads)
    got, payloads = cs.loopback_block(configs, plen, nf, t_block, np.random.default_rng(0), "cpu")
    np.testing.assert_array_equal(payloads, np.stack(sent))
    assert got.dtype == torch.complex64 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), x, atol=1e-5 * np.abs(x).max())
