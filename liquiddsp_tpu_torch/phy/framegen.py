"""Frame generator (TX): the reference's flex_tx / liquid flexframegen analog.

Counterpart of ``liquiddsp_tpu/phy/framegen.py``: a whole-batch computation,
[B] payloads -> [B, frame_samples] complex baseband.

TX chain (see phy/frame_spec.py for the format):
  payload -> CRC24 -> outer FEC -> inner FEC -> interleave -> modulate
  header  -> CRC24 -> Golay     -> QPSK
  [preamble | header syms | payload syms] -> RRC interp (k=2, 'full')
"""

from __future__ import annotations

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import device_const, resolve_device
from liquiddsp_tpu_torch.ops import bits as bitops
from liquiddsp_tpu_torch.ops import crc, fir, modem
from liquiddsp_tpu_torch.ops.fec import registry
from liquiddsp_tpu_torch.ops.fec.block import golay2412
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.tables import PhyTables, phy_tables


def _header_device(user_header: torch.Tensor | None, device) -> torch.device:
    """``device`` as given, else the user header's, else the card (raises
    without one)."""
    if device is None and user_header is not None:
        return user_header.device
    return resolve_device(device)


def build_header_bytes(
    cfg: FrameConfig,
    batch: int,
    user_header: torch.Tensor | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """[B, 19] header bytes: 14 user + payload_len u16 BE + mod + inner + outer.

    Default user header is 14 zero bytes. ``device=None``: the user
    header's device, else the GPU."""
    device = _header_device(user_header, device)
    if user_header is None:
        user_header = torch.zeros((batch, fs.HEADER_USER_BYTES), dtype=torch.uint8, device=device)
    proto = device_const(
        ("header_proto", cfg.payload_len, cfg.modulation, cfg.inner_code, cfg.outer_code),
        lambda: np.array([(cfg.payload_len >> 8) & 0xFF, cfg.payload_len & 0xFF,
                          cfg.modulation, cfg.inner_code, cfg.outer_code], np.uint8),
        device,
    ).repeat(batch, 1)
    return torch.cat([user_header.to(device), proto], dim=-1)


def header_bytes_to_symbols(hdr_bytes: torch.Tensor) -> torch.Tensor:
    """CRC'd header bytes [..., 22] -> the 180 QPSK header symbols
    (zero-pad to 180 bits, Golay(24,12), QPSK)."""
    bits = bitops.bytes_to_bits(hdr_bytes)  # [..., 176]
    pad = fs.HEADER_BITS_PADDED - fs.HEADER_BITS
    zeros = torch.zeros(bits.shape[:-1] + (pad,), dtype=bits.dtype, device=bits.device)
    coded = golay2412().encode(torch.cat([bits, zeros], dim=-1))  # [..., 360]
    return modem.modulate(modem.bits_to_indices(coded, 2), fs.HEADER_MOD)


def header_symbols(
    cfg: FrameConfig,
    batch: int,
    user_header: torch.Tensor | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """[B, HEADER_SYMS] QPSK header symbols (CRC24 + Golay + QPSK).
    ``device=None``: the user header's device, else the GPU."""
    hdr = crc.crc24_append(build_header_bytes(cfg, batch, user_header, device))
    return header_bytes_to_symbols(hdr)


def payload_symbols(
    payload: torch.Tensor, cfg: FrameConfig, tables: PhyTables | None = None
) -> torch.Tensor:
    """[B, payload_len] uint8 -> [B, payload_syms] complex symbols.
    ``tables=None``: ``phy_tables(cfg)`` on the payload's device."""
    if tables is None:
        tables = phy_tables(cfg, payload.device)
    spec = fs.FrameSpec(cfg)
    msg = crc.crc24_append(payload)  # [B, L+3]
    obits = registry.outer_encode(msg, cfg.outer_code)
    ibits = registry.inner_encode(obits, cfg.inner_code)
    ibits = ibits[..., tables.interleave_perm]
    pad = spec.payload_pad_bits
    if pad:
        zeros = torch.zeros(ibits.shape[:-1] + (pad,), dtype=ibits.dtype, device=ibits.device)
        ibits = torch.cat([ibits, zeros], dim=-1)
    idx = modem.bits_to_indices(ibits, spec.bps)
    return modem.modulate(idx, cfg.modulation)


def assemble_symbols(
    payload: torch.Tensor,
    cfg: FrameConfig,
    user_header: torch.Tensor | None = None,
    tables: PhyTables | None = None,
) -> torch.Tensor:
    """[B, payload_len] payload bytes -> [B, frame_syms] symbols, on the
    payload's device. ``tables=None``: ``phy_tables(cfg)`` there."""
    if tables is None:
        tables = phy_tables(cfg, payload.device)
    batch = payload.shape[0]
    hdr = header_symbols(cfg, batch, user_header, payload.device)
    pay = payload_symbols(payload, cfg, tables)
    return torch.cat([tables.preamble[None, :].expand(batch, -1), hdr, pay], dim=-1)


def write_samples(symbols: torch.Tensor, tables: PhyTables | None = None) -> torch.Tensor:
    """[B, n_syms] -> [B, k*n_syms + 28] RRC-interpolated baseband (k=2).
    ``tables=None``: ``phy_tables()`` on the symbols' device."""
    if tables is None:
        tables = phy_tables(None, symbols.device)
    return fir.interp_full(symbols, tables.rrc_taps, fs.K_SAMP)


def framegen(
    payload: torch.Tensor,
    cfg: FrameConfig,
    user_header: torch.Tensor | None = None,
    tables: PhyTables | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Full TX: [B, payload_len] uint8 -> [B, frame_samples] complex64 on
    ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    if tables is None:
        tables = phy_tables(cfg, dev)
    payload = torch.as_tensor(payload, dtype=torch.uint8).to(dev)
    return write_samples(assemble_symbols(payload, cfg, user_header, tables), tables)


def frame_length(cfg: FrameConfig) -> int:
    """flexframegen_getframelen analog."""
    return fs.FrameSpec(cfg).frame_samples
