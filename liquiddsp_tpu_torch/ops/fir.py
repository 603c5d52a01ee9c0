"""Batched FIR filtering: the TX pulse-shaping interpolator and real-tap
convolutions of complex rows.

Counterpart of ``liquiddsp_tpu/ops/fir.py``. Taps are real (RRC family,
windowed sincs), signals complex64 or float32; a complex-by-real
convolution is two real convolutions, here one ``conv1d`` over the real and
imaginary planes stacked as rows.

A float32 ``conv1d`` on the GPU goes through cuDNN in TF32 by default, which
keeps about three decimal digits. ``conv_full`` and ``conv_same`` run it with
TF32 off for the call (``torch.backends.cudnn.flags``, a scoped context
manager). The interpolator, whose output the receiver's parity with the
reference hangs on, is zero-stuffing plus one shifted multiply-add per tap,
all in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def conv1d_f32(rows: torch.Tensor, weight: torch.Tensor, pad_l: int = 0,
               pad_r: int = 0) -> torch.Tensor:
    """``conv1d`` of float32 rows [N, 1, T] with filters [O, 1, L] -> [N, O,
    T + pad_l + pad_r - L + 1] (a correlation: the filters are not flipped),
    TF32 off on the GPU; the caller's other cuDNN settings hold."""
    rows = torch.nn.functional.pad(rows, (pad_l, pad_r))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return torch.nn.functional.conv1d(rows, weight)


def _conv(x: torch.Tensor, h, pad_l: int, pad_r: int) -> torch.Tensor:
    """True convolution of [..., T] with real taps [L] over the last axis,
    zero-padded by ``pad_l`` / ``pad_r``; complex64 out for complex input."""
    taps = torch.as_tensor(h, dtype=torch.float32).to(x.device)
    cplx = x.is_complex()
    planes = torch.stack([x.real, x.imag]) if cplx else x.to(torch.float32)[None]
    lead = planes.shape[:-1]
    y = conv1d_f32(planes.reshape(-1, 1, planes.shape[-1]), taps.flip(0)[None, None],
                   pad_l, pad_r)
    y = y.reshape(lead + (y.shape[-1],))
    return torch.complex(y[0], y[1]) if cplx else y[0]


def conv_full(x: torch.Tensor, h: np.ndarray | torch.Tensor) -> torch.Tensor:
    """'full' convolution of [..., T] with real taps [L] -> [..., T + L - 1]."""
    pad = len(h) - 1
    return _conv(x, h, pad, pad)


def conv_same(x: torch.Tensor, h: np.ndarray | torch.Tensor) -> torch.Tensor:
    """'same' convolution: output aligned with input, length T."""
    l = len(h)
    pad_l = (l - 1) // 2
    return _conv(x, h, pad_l, l - 1 - pad_l)


def interp_full(syms: torch.Tensor, h: np.ndarray | torch.Tensor, k: int) -> torch.Tensor:
    """Zero-stuff complex symbols [..., n] by k, 'full'-convolve with real
    taps [L] -> [..., k*n + L - 1] complex64."""
    # the taps stay on the device (a tensor of them is read there, never
    # back on the host), so that the call can run inside a CUDA graph
    taps = (h if isinstance(h, torch.Tensor) else torch.from_numpy(np.asarray(h))).to(
        device=syms.device, dtype=torch.float32)
    n = syms.shape[-1]
    n_out = k * n + taps.shape[0] - 1
    up = torch.zeros(syms.shape[:-1] + (k * n,), dtype=torch.complex64, device=syms.device)
    up[..., ::k] = syms.to(torch.complex64)
    out = torch.zeros(syms.shape[:-1] + (n_out,), dtype=torch.complex64, device=syms.device)
    for j in range(taps.shape[0]):
        out[..., j : j + k * n] += up * taps[j]
    return out


def matched_filter_decimate(
    x: torch.Tensor, h: np.ndarray | torch.Tensor, k: int, offset: int
) -> torch.Tensor:
    """Matched-filter then take every k-th sample starting at ``offset``.

    x: [..., T] aligned so the first symbol's pulse center lands at sample
    ``offset`` of the 'full'-convolved output (= len(h)-1 when x starts at the
    frame start).
    """
    return conv_full(x, h)[..., offset::k]
