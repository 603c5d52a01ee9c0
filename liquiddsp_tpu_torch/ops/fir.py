"""Batched FIR filtering: the TX pulse-shaping interpolator.

Counterpart of ``liquiddsp_tpu/ops/fir.py`` (``interp_full`` only so far).
Taps are real (RRC family), signals complex64.

A float32 ``conv1d`` on the GPU goes through cuDNN in TF32 by default, which
keeps about three decimal digits; the receiver's parity with the reference
hangs on an f32-exact TX waveform. So the interpolator is written as
zero-stuffing plus one shifted multiply-add per tap, all in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def interp_full(syms: torch.Tensor, h: np.ndarray | torch.Tensor, k: int) -> torch.Tensor:
    """Zero-stuff complex symbols [..., n] by k, 'full'-convolve with real
    taps [L] -> [..., k*n + L - 1] complex64."""
    taps = torch.as_tensor(h, dtype=torch.float32).tolist()
    n = syms.shape[-1]
    n_out = k * n + len(taps) - 1
    up = torch.zeros(syms.shape[:-1] + (k * n,), dtype=torch.complex64, device=syms.device)
    up[..., ::k] = syms.to(torch.complex64)
    out = torch.zeros(syms.shape[:-1] + (n_out,), dtype=torch.complex64, device=syms.device)
    for j, tap in enumerate(taps):
        out[..., j : j + k * n] += up * tap
    return out
