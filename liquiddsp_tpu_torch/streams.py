"""Synthetic receive streams for smoke runs and profiles."""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.phy import framegen


def tiled_stream(
    cfg: FrameConfig,
    snr_db: float,
    batch: int,
    block: int,
    gen: torch.Generator,
    device: torch.device | str | None = None,
):
    """The block receiver's standard load: per row one random payload, its
    frame tiled as [37 lead-in | frame | 0.8 f gap] to ``block`` samples, plus
    AWGN at ``snr_db`` (noise from ``gen``, which lives on ``device``).

    Returns (x [batch, block] complex64, payloads [batch, payload_len] uint8,
    whole frames per row, max_frames for the receiver)."""
    dev = resolve_device(device)
    payloads = torch.randint(
        0, 256, (batch, cfg.payload_len), generator=gen, device=dev, dtype=torch.int32
    ).to(torch.uint8)
    frames = framegen.framegen(payloads, cfg, device=dev)
    f = frames.shape[1]
    gap = int(0.8 * f)
    period = 37 + f + gap
    n_frames = sum(1 for i in range(block // period + 1) if 37 + i * period + f <= block)
    zeros = lambda n: torch.zeros((batch, n), dtype=torch.complex64, device=dev)
    pattern = torch.cat([zeros(37), frames, zeros(gap)], dim=1)
    x = pattern.repeat(1, -(-block // period))[:, :block]
    sigma = torch.sqrt(torch.mean(torch.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10)))
    noise = torch.complex(
        torch.randn((batch, block), generator=gen, device=dev),
        torch.randn((batch, block), generator=gen, device=dev),
    )
    x = (x + sigma * noise).to(torch.complex64).contiguous()
    return x, payloads, n_frames, block // period + 2
