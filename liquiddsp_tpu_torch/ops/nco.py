"""Numerically-controlled oscillator: mixing / derotation, batched.

Counterpart of ``liquiddsp_tpu/ops/nco.py``. A mix is a closed-form phase
ramp exp(-j(dphi*n + phi)); ``pll_track`` is the decision-directed
second-order loop, one step a symbol: a plain loop over time, batched over
rows. No receiver path calls it (the receiver's carrier refinement is the
closed-form header fit in phy/framesync.py).
"""

from __future__ import annotations

import torch


def mix_down(x: torch.Tensor, dphi, phi=0.0) -> torch.Tensor:
    """Derotate [..., T] by carrier dphi (rad/sample) and phase phi.

    dphi/phi may be scalars or [...]-shaped per-row estimates."""
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    dphi = torch.as_tensor(dphi, dtype=torch.float32, device=x.device)[..., None]
    phi = torch.as_tensor(phi, dtype=torch.float32, device=x.device)[..., None]
    return x * torch.exp(-1j * (dphi * n + phi))


def mix_up(x: torch.Tensor, dphi, phi=0.0) -> torch.Tensor:
    return mix_down(x, -torch.as_tensor(dphi, dtype=torch.float32),
                    -torch.as_tensor(phi, dtype=torch.float32))


def pll_track(symbols: torch.Tensor, reference: torch.Tensor, bw: float = 0.02):
    """Decision-directed second-order PLL over a symbol stream.

    symbols/reference: [B, N]. Returns (corrected [B, N], phase trajectory
    [B, N]): the batched analog of liquid's nco_crcf_pll_step."""
    alpha = bw
    beta = 0.25 * bw * bw
    b = symbols.shape[0]
    phase = torch.zeros(b, dtype=torch.float32, device=symbols.device)
    freq = torch.zeros(b, dtype=torch.float32, device=symbols.device)
    out, traj = [], []
    for t in range(symbols.shape[1]):
        corrected = symbols[:, t] * torch.exp(-1j * phase)
        err = torch.angle(corrected * torch.conj(reference[:, t]))
        freq = freq + beta * err
        phase = phase + freq + alpha * err
        out.append(corrected)
        traj.append(phase)
    return torch.stack(out, dim=1), torch.stack(traj, dim=1)
