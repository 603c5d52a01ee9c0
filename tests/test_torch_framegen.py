"""TX of the PyTorch port against the JAX package: symbols exact (they come
from bit-exact coding and the same tables), waveform to atol 1e-6 (29-tap
float32 sums in another order, samples of order 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.phy import frame_spec as tfs
from liquiddsp_tpu_torch.phy import framegen as tframegen
from liquiddsp_tpu_torch.phy.tables import phy_tables

CONFIGS = [(1, 0, 0, 64), (1, 1, 1, 64), (8, 3, 1, 32), (10, 0, 1, 32)]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_frame_symbols_exact(cfg):
    rng = np.random.default_rng(sum(cfg))
    payload = rng.integers(0, 256, (3, cfg[3]), dtype=np.uint8)
    user = rng.integers(0, 256, (3, 14), dtype=np.uint8)
    sj = np.asarray(jframegen.assemble_symbols(
        jnp.asarray(payload), JFrameConfig(*cfg), jnp.asarray(user)))
    tc = FrameConfig(*cfg)
    st = tframegen.assemble_symbols(
        torch.from_numpy(payload), tc, torch.from_numpy(user), phy_tables(tc, "cpu"))
    assert st.shape == (3, tfs.FrameSpec(tc).frame_syms)
    np.testing.assert_array_equal(sj, st.numpy())


@pytest.mark.parametrize("cfg", CONFIGS)
def test_waveform_close(cfg):
    rng = np.random.default_rng(7 + sum(cfg))
    payload = rng.integers(0, 256, (2, cfg[3]), dtype=np.uint8)
    xj = np.asarray(jframegen.framegen(jnp.asarray(payload), JFrameConfig(*cfg)))
    tc = FrameConfig(*cfg)
    xt = tframegen.framegen(torch.from_numpy(payload), tc, device="cpu")
    assert xt.dtype == torch.complex64
    assert xt.shape == (2, tframegen.frame_length(tc)) == xj.shape
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-6)
