"""Byte <-> bit packing helpers (MSB-first), batched."""

from __future__ import annotations

import numpy as np
import torch

from liquiddsp_tpu_torch.core.device import device_const


def bytes_to_bits(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., L] -> int8 bits [..., 8L], MSB first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=b.device)
    bits = (b.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(b.shape[:-1] + (b.shape[-1] * 8,)).to(torch.int8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """int bits [..., 8L] -> uint8 [..., L], MSB first."""
    shape = bits.shape[:-1] + (bits.shape[-1] // 8, 8)
    weights = device_const(
        ("byte_weights",), lambda: np.array([128, 64, 32, 16, 8, 4, 2, 1], np.int32), bits.device)
    v = torch.sum(bits.reshape(shape).to(torch.int32) * weights, dim=-1)
    return v.to(torch.uint8)


def bytes_to_bits_host(b: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(b, dtype=np.uint8), axis=-1)


def bits_to_bytes_host(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1)
