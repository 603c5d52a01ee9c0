"""Synthetic receive streams for smoke runs and profiles."""

from __future__ import annotations

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.ops import modem, resample
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.phy.tables import phy_tables


def tiled_stream(
    cfg: FrameConfig,
    snr_db: float,
    batch: int,
    block: int,
    gen: torch.Generator,
    device: torch.device | str | None = None,
    tail_margin: int = 0,
):
    """The block receiver's standard load: per row one random payload, its
    frame tiled as [37 lead-in | frame | 0.8 f gap] to ``block`` samples, plus
    AWGN at ``snr_db`` (noise from ``gen``, which lives on ``device``).

    Returns (x [batch, block] complex64, payloads [batch, payload_len] uint8,
    whole frames per row, max_frames for the receiver). A frame counts as
    whole when it ends ``tail_margin`` samples before the block's end or
    earlier: a transform ahead of the receiver (a resampler at a rate other
    than 1) may move the last frame that far."""
    dev = resolve_device(device)
    payloads = torch.randint(
        0, 256, (batch, cfg.payload_len), generator=gen, device=dev, dtype=torch.int32
    ).to(torch.uint8)
    frames = framegen.framegen(payloads, cfg, device=dev)
    f, period = frames.shape[1], _period(cfg)
    gap = period - 37 - f
    n_frames = sum(1 for i in range(block // period + 1)
                   if 37 + i * period + f <= block - tail_margin)
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


# bench.py's resampled configuration (BASELINE config 3): four sample-clock
# groups of channels, in ppm
RESAMPLED_PPMS = (-50.0, -20.0, 20.0, 50.0)
# bench.py's tail margin for that configuration: a frame counts as whole when
# it ends this many samples before the block's end
RESAMPLED_TAIL_MARGIN = 64


def resampled_stream(
    cfg: FrameConfig,
    snr_db: float,
    batch: int,
    block: int,
    ppms,
    gen: torch.Generator,
    device: torch.device | str | None = None,
):
    """The resampled receiver's load (BASELINE config 3, bench.py's
    ``bench_resampled``): ``tiled_stream`` with ``RESAMPLED_TAIL_MARGIN`` and
    the rates 1 + ppm * 1e-6 of ``len(ppms)`` equal groups of channels, which
    the receiver resamples with ``ops.resample.arbitrary_groups`` ahead of
    ``framesync_fixed``. Returns ``tiled_stream``'s tuple and the rates."""
    if batch % len(ppms):
        raise ValueError(f"{batch} channels do not split into {len(ppms)} groups")
    stream = tiled_stream(cfg, snr_db, batch, block, gen, device, RESAMPLED_TAIL_MARGIN)
    return (*stream, tuple(1.0 + p * 1e-6 for p in ppms))


def stretched_stream(
    cfg: FrameConfig,
    snr_db: float,
    ppm: float,
    batch: int,
    block: int,
    gen: torch.Generator,
    device: torch.device | str | None = None,
):
    """``tiled_stream``'s rows with a sample-clock offset: even rows
    resampled by +``ppm`` and odd rows by -``ppm`` (frames stretched or
    squeezed by ``ops.resample.arbitrary``), then AWGN at ``snr_db``. Same
    returns as ``tiled_stream``."""
    dev = resolve_device(device)
    x, payloads, n_frames, max_frames = tiled_stream(cfg, float("inf"), batch, block, gen, dev)
    for rows, sign in ((slice(0, None, 2), 1.0), (slice(1, None, 2), -1.0)):
        x[rows] = resample.arbitrary(x[rows], 1.0 / (1.0 + sign * ppm * 1e-6), block)
    frames = framegen.framegen(payloads, cfg, device=dev)
    sigma = torch.sqrt(torch.mean(torch.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10)))
    noise = torch.complex(
        torch.randn((batch, block), generator=gen, device=dev),
        torch.randn((batch, block), generator=gen, device=dev),
    )
    return (x + sigma * noise).contiguous(), payloads, n_frames, max_frames


def _period(cfg: FrameConfig) -> int:
    """Samples from one frame start to the next in both tilings."""
    f = framegen.frame_length(cfg)
    return 37 + f + int(0.8 * f)


def shard_slots(cfg: FrameConfig, t_local: int) -> int:
    """Slots a time shard of ``t_local`` samples needs for a ``long_stream``:
    every frame that starts in the shard's window of t_local + frame_samples
    - 1 samples, and two to spare."""
    return (t_local + framegen.frame_length(cfg) - 1) // _period(cfg) + 2


def long_stream(
    cfg: FrameConfig,
    snr_db: float,
    batch: int,
    total: int,
    gen: torch.Generator,
    device: torch.device | str | None = None,
):
    """A few long channels for the time-sharded receiver: per row the same
    [lead-in | frame | 0.8 f gap] tiling as ``tiled_stream`` to ``total``
    samples plus AWGN at ``snr_db``, but with a DIFFERENT random payload for
    every frame, so that a frame decoded twice or in the wrong place shows.
    Row b's lead-in is 37 + b * period / batch samples: the channels are not
    aligned with each other, so whatever the shard length, frames of some
    rows straddle the shard boundaries.

    Returns (x [batch, total] complex64, payloads [batch, n_slots,
    payload_len] uint8, starts [batch, n_slots] int64: the true start of
    every frame, whole [batch, n_slots] bool: the frame lies wholly inside
    the stream). A frame cut by the end of the stream is in ``x`` as far as
    it fits and is not ``whole``."""
    dev = resolve_device(device)
    f, period = framegen.frame_length(cfg), _period(cfg)
    n_slots = -(-total // period)
    payloads = torch.randint(
        0, 256, (batch, n_slots, cfg.payload_len), generator=gen, device=dev, dtype=torch.int32
    ).to(torch.uint8)
    frames = framegen.framegen(payloads.reshape(batch * n_slots, -1), cfg, device=dev)
    slots = torch.zeros((batch, n_slots, period), dtype=torch.complex64, device=dev)
    slots[:, :, :f] = frames.reshape(batch, n_slots, f)
    lead = 37 + (torch.arange(batch, device=dev) * period) // batch  # [batch]
    idx = torch.arange(total, device=dev)[None, :] - lead[:, None]
    x = torch.gather(slots.reshape(batch, n_slots * period), 1, idx.clamp(min=0))
    x = torch.where(idx >= 0, x, torch.zeros_like(x))
    sigma = torch.sqrt(torch.mean(torch.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10)))
    noise = torch.complex(
        torch.randn((batch, total), generator=gen, device=dev),
        torch.randn((batch, total), generator=gen, device=dev),
    )
    x = (x + sigma * noise).to(torch.complex64).contiguous()
    starts = lead[:, None] + period * torch.arange(n_slots, device=dev)[None, :]
    return x, payloads, starts, starts + f <= total


def burst_stream(
    cfg: FrameConfig,
    snr_db: float,
    batch: int,
    total: int,
    burst: tuple[int, int],
    gen: torch.Generator,
    device: torch.device | str | None = None,
):
    """``long_stream``'s tiling (a different payload for every frame, all rows
    aligned at a 37-sample lead-in) except that frames starting in the
    sample range ``burst = (begin, end)`` follow each other back to back,
    16 samples apart: a burst of demand for a streaming receiver. Only whole
    frames are placed. Same returns as ``long_stream``."""
    dev = resolve_device(device)
    f, period = framegen.frame_length(cfg), _period(cfg)
    starts, s = [], 37
    while s + f <= total:
        starts.append(s)
        s += f + 16 if burst[0] <= s < burst[1] else period
    n = len(starts)
    payloads = torch.randint(
        0, 256, (batch, n, cfg.payload_len), generator=gen, device=dev, dtype=torch.int32
    ).to(torch.uint8)
    frames = framegen.framegen(payloads.reshape(batch * n, -1), cfg, device=dev).reshape(batch, n, f)
    x = torch.zeros((batch, total), dtype=torch.complex64, device=dev)
    for j, s in enumerate(starts):
        x[:, s : s + f] = frames[:, j]
    sigma = torch.sqrt(torch.mean(torch.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10)))
    noise = torch.complex(
        torch.randn((batch, total), generator=gen, device=dev),
        torch.randn((batch, total), generator=gen, device=dev),
    )
    starts_t = torch.as_tensor(starts, dtype=torch.int64, device=dev).expand(batch, n)
    return (x + sigma * noise).contiguous(), payloads, starts_t, torch.ones_like(starts_t, dtype=torch.bool)


def fade_slip_symbols(cfg: FrameConfig, batch: int, seed: int,
                      device: torch.device | str | None = None):
    """Frame symbols with the slip of sub-frame fading that
    ``decode_payload_symbols(slip_retry=True)`` recovers: per row a random
    payload (numpy, from ``seed``), its frame's symbols with the 32-symbol
    payload segment 2 + row % 4 faded to 0.05, every symbol after it
    rotated by one symmetry period of the modulation (+ on even rows, - on
    odd), plus complex Gaussian noise of deviation 0.01 a component.

    Returns (symbols [batch, frame_syms] complex64, payloads [batch,
    payload_len] uint8), both on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (batch, cfg.payload_len), dtype=np.uint8)
    syms = framegen.assemble_symbols(torch.from_numpy(payloads).to(dev), cfg, None,
                                     phy_tables(cfg, dev)).cpu().numpy()
    h1 = fs.PREAMBLE_SYMS + fs.HEADER_SYMS
    period = modem.rotational_symmetry(cfg.modulation)
    for b in range(batch):
        a = h1 + 32 * (2 + b % 4)
        syms[b, a : a + 32] *= 0.05
        syms[b, a + 32 :] *= np.exp(1j * period * (1 if b % 2 == 0 else -1))
    syms = syms + 0.01 * (rng.standard_normal(syms.shape) + 1j * rng.standard_normal(syms.shape))
    return (torch.from_numpy(syms.astype(np.complex64)).to(dev),
            torch.from_numpy(payloads).to(dev))
