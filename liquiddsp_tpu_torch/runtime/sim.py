"""Simulation blocks for flowgraphs: packet source + AWGN channel.

Counterpart of ``liquiddsp_tpu/runtime/sim.py``. The reference's GRC
flowgraphs combine its four blocks with GNU Radio's own sources and channel
models; these stand in for them so a closed loop needs nothing else. The
payloads are host data drawn with numpy's generator, as the JAX package
draws them; the channel noise comes from a seeded ``torch.Generator`` on the
device, so it differs from ``jax.random``'s in its samples, not in its power.
"""

from __future__ import annotations

import numpy as np
import torch

from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.runtime.bus import PDU, MessageBus


class PacketSource:
    """Random-payload packet source: one PDU per :meth:`step` on ``pdus``.

    Keeps ``sent`` (host copies of every payload) so a caller or test can
    check bit-exact recovery downstream.
    """

    def __init__(self, payload_len: int = 32, seed: int = 0,
                 bus: MessageBus | None = None):
        self.bus = bus or MessageBus()
        self.payload_len = int(payload_len)
        self.rng = np.random.default_rng(seed)
        self.sent: list[np.ndarray] = []

    def step(self) -> PDU:
        p = self.rng.integers(0, 256, (1, self.payload_len), dtype=np.uint8)
        self.sent.append(p[0].copy())
        pdu = PDU(meta={"n": len(self.sent) - 1}, data=p)
        self.bus.publish("pdus", pdu)
        return pdu


class ChannelModel:
    """AWGN channel block: frame PDUs [B, F] in, noisy sample blocks
    [B, F + pad] out, with the frames at ``offset``. ``set_snr`` and the
    ``snr`` message input retune the noise level (signal power measured over
    the frames)."""

    def __init__(self, snr_db: float = 18.0, pad: int = 1024,
                 offset: int = 512, seed: int = 0,
                 bus: MessageBus | None = None, *,
                 device: torch.device | str | None = None):
        self.bus = bus or MessageBus()
        self.snr_db = float(snr_db)
        self.pad = int(pad)
        self.offset = int(offset)
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.bus.subscribe("pdus_in", self.apply)
        self.bus.subscribe("snr", self.set_snr)

    def set_snr(self, snr_db) -> None:
        self.snr_db = float(snr_db)

    def apply(self, pdu: PDU | torch.Tensor) -> torch.Tensor:
        frames = pdu.data if isinstance(pdu, PDU) else pdu
        frames = torch.as_tensor(frames).to(device=self.device, dtype=torch.complex64)
        b, f = frames.shape
        t = f + self.pad
        x = torch.zeros((b, t), dtype=torch.complex64, device=self.device)
        x[:, self.offset : self.offset + f] = frames
        p_sig = torch.mean(torch.abs(frames) ** 2)
        sigma = torch.sqrt(p_sig / (2.0 * 10.0 ** (self.snr_db / 10.0)))
        noise = torch.complex(
            torch.randn((b, t), generator=self._gen, device=self.device),
            torch.randn((b, t), generator=self._gen, device=self.device),
        )
        x = x + sigma * noise
        self.bus.publish("samples", x)
        return x
