"""slip_retry of decode_payload_symbols in the PyTorch port against the JAX
package. Frames whose payload fades deeply in one 32-symbol segment and
comes out of the fade rotated by one symmetry period of the modulation
(streams.fade_slip_symbols: a quarter turn for QPSK, an eighth for 8-PSK;
half the rows one way, half the other) fail their CRC as tracked and are
recovered by slip_retry, in both packages, with bytes and crc_ok equal
between them; and slip_retry leaves differential modulations and untracked
decodes as they were."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.phy import framesync as jsync
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.phy import framesync as tsync
from liquiddsp_tpu_torch.streams import fade_slip_symbols

FRAMES, NOISE_VAR = 8, 0.01
CONFIGS = {"qpsk": (1, 0, 0, 64), "qpsk_v27_golay": (1, 1, 1, 64), "psk8_v27": (2, 1, 0, 64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def symbols(name):
    syms, payloads = fade_slip_symbols(FrameConfig(*CONFIGS[name]), FRAMES, seed=5, device="cpu")
    return syms.numpy(), payloads.numpy()


@functools.lru_cache(maxsize=None)
def jax_decode(name, slip_retry):
    syms, _ = symbols(name)
    fn = jax.jit(functools.partial(jsync.decode_payload_symbols, cfg=JFrameConfig(*CONFIGS[name]),
                                   noise_var=NOISE_VAR, slip_retry=slip_retry))
    msg, ok = fn(jnp.asarray(syms))
    return np.asarray(msg), np.asarray(ok)


def port_decode(name, slip_retry, **kw):
    syms, _ = symbols(name)
    msg, ok = tsync.decode_payload_symbols(torch.from_numpy(syms), FrameConfig(*CONFIGS[name]),
                                           noise_var=NOISE_VAR, slip_retry=slip_retry, **kw)
    return msg.numpy(), ok.numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("slip_retry", [True, False])
def test_port_equals_jax(name, slip_retry):
    ref_msg, ref_ok = jax_decode(name, slip_retry)
    msg, ok = port_decode(name, slip_retry)
    assert msg.dtype == np.uint8 and ok.dtype == np.bool_
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(msg, ref_msg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slip_retry_recovers_what_tracking_loses(name):
    _, payloads = symbols(name)
    for decode in (port_decode, jax_decode):
        msg, ok = decode(name, True)
        assert ok.all() and np.array_equal(msg, payloads)
        _, ok = decode(name, False)
        assert not ok.any()


def test_no_retry_without_tracker_or_for_differential():
    """slip_retry needs the tracker's fading weights and a coherent
    modulation: with track=False, and for DQPSK, it changes nothing."""
    a = port_decode("qpsk", True, track=False)
    b = port_decode("qpsk", False, track=False)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    cfg = FrameConfig(5, 0, 0, 64)  # DQPSK
    syms, _ = fade_slip_symbols(cfg, 2, seed=1, device="cpu")
    a = tsync.decode_payload_symbols(syms, cfg, noise_var=NOISE_VAR, slip_retry=True)
    b = tsync.decode_payload_symbols(syms, cfg, noise_var=NOISE_VAR, slip_retry=False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
