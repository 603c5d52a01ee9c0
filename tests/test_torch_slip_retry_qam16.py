"""slip_retry on the reference's payload-tracker slips (ROADMAP.md C): 32
random 1200-byte QAM16 payloads (seeds 0-31), one frame each without noise
or drift (tests/test_torch_sfo.py's stream), through framesync_fixed with
and without slip_retry in both packages. The tracker slips on some of them
with no fade to mark the slip, so slip_retry is not expected to recover
them; the test holds only that the two packages decode the same payloads in
each setting, with bytes equal to those sent wherever the CRC passes."""

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
from liquiddsp_tpu_torch.phy.framegen import framegen
from test_torch_sfo import QAM16, T, payload_of

N = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def block():
    """make_sfo_block's rows at 0 ppm and without noise (the frame at sample
    300, carrier 0.004 rad/sample, phase 0.7), the 32 frames made by one call
    of the port's framegen (equal to the JAX package's,
    tests/test_torch_framegen.py)."""
    payloads = np.concatenate([payload_of(1200, s) for s in range(N)])
    frames = framegen(torch.from_numpy(payloads), FrameConfig(*QAM16), device="cpu").numpy()
    x = np.zeros((N, T), dtype=np.complex64)
    x[:, 300 : 300 + frames.shape[1]] = frames
    x = x * np.exp(1j * (0.004 * np.arange(T) + 0.7))
    return x.astype(np.complex64), payloads


def decoded(res, payloads):
    """[N] bool: row b passed its CRC with the payload sent (and no row
    passed with another)."""
    valid, pay = res["payload_valid"], res["payload"]
    assert not (valid & ~(pay == payloads[:, None, :]).all(-1)).any()
    return valid.any(axis=1)


@pytest.mark.parametrize("slip_retry", [False, True])
def test_packages_decode_the_same_payloads(slip_retry):
    x, payloads = block()
    fn = jax.jit(functools.partial(jsync.framesync_fixed, cfg=JFrameConfig(*QAM16), max_frames=2,
                                   slip_retry=slip_retry))
    r = fn(jnp.asarray(x))
    ref = decoded({k: np.asarray(getattr(r, k)) for k in ("payload_valid", "payload")}, payloads)
    got = decoded(tsync.framesync_fixed(torch.from_numpy(x), FrameConfig(*QAM16), 2,
                                        slip_retry=slip_retry, device="cpu").to_numpy(), payloads)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < N  # the tracker slips on some, as ROADMAP.md C records
