"""Automatic gain control, batched.

Counterpart of ``liquiddsp_tpu/ops/agc.py``. liquid's flexframesync runs a
per-sample AGC in front of detection; here:

- ``agc_block``: one gain per row (RMS normalise).
- ``agc_windowed``: sliding-window RMS gain, fully parallel (cumsum), for
  slowly varying levels.
- ``agc_scan``: the first-order tracking loop (attack/decay bandwidth
  ``alpha``), one step a sample: a plain loop over time, batched over rows.
  No receiver path calls it; it is there for experiments where the loop's
  dynamics matter.
"""

from __future__ import annotations

import torch


def agc_block(x: torch.Tensor, target_rms: float = 1.0, eps: float = 1e-12):
    """[..., T] -> (normalised, gain[...]): one gain per trailing axis."""
    rms = torch.sqrt(torch.mean(torch.abs(x) ** 2, dim=-1) + eps)
    gain = target_rms / rms
    return x * gain[..., None], gain


def agc_windowed(x: torch.Tensor, window: int = 256, target_rms: float = 1.0,
                 eps: float = 1e-12):
    """Sliding-RMS gain: [..., T] -> (y, gain [..., T]). Causal window."""
    cs = torch.cumsum(torch.abs(x) ** 2, dim=-1)
    t = x.shape[-1]
    csp = torch.nn.functional.pad(cs, (window, 0))
    win_sum = cs - csp[..., :-window][..., :t]
    n = torch.clamp(torch.arange(1, t + 1, device=x.device), max=window)
    rms = torch.sqrt(win_sum / n + eps)
    gain = target_rms / torch.clamp(rms, min=eps)
    return x * gain, gain


def agc_scan(x: torch.Tensor, alpha: float = 0.01, target_rms: float = 1.0,
             eps: float = 1e-12):
    """First-order tracking AGC (liquid agc_crcf-style loop), one step a
    sample. x: [B, T]. Returns (y, gain [B, T])."""
    g = torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)
    ys, gains = [], []
    for t in range(x.shape[-1]):
        y = x[..., t] * g
        ys.append(y)
        gains.append(g)
        g = g * torch.exp(alpha * (target_rms - torch.abs(y)))
    return torch.stack(ys, dim=-1), torch.stack(gains, dim=-1)
