"""Cyclic redundancy checks, batched over messages.

Counterpart of ``liquiddsp_tpu/ops/crc.py``. The payload and header check is
CRC-24/OPENPGP: polynomial 0x864CFB, init 0xB704CE, no reflection, no final
xor, 3-byte checksum appended big-endian. CRC-16 (CCITT 0x1021, init 0xFFFF)
and CRC-32 (reflected 0xEDB88320, zlib-compatible) complete the family.

A CRC is GF(2)-affine in the message bits: crc(m) = c0 ^ (bits(m) @ F). One
[N, 8L] x [8L, W] float32 product against the per-length constant matrix
replaces the byte-serial table walk; it is exact because row sums stay far
below 2^24.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from liquiddsp_tpu_torch.core.device import device_const

CRC24_POLY = 0x864CFB
CRC24_INIT = 0xB704CE
CRC16_POLY = 0x1021
CRC16_INIT = 0xFFFF
CRC32_POLY_REFLECTED = 0xEDB88320
CRC32_INIT = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _crc_table(poly: int, width: int) -> np.ndarray:
    """MSB-first CRC table: table[b] = CRC update of byte b from zero state."""
    topbit = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        reg = b << (width - 8)
        for _ in range(8):
            reg = ((reg << 1) ^ poly) if (reg & topbit) else (reg << 1)
            reg &= mask
        table[b] = reg
    return table


def _crc_host(data: bytes, poly: int, width: int, init: int) -> int:
    table = _crc_table(poly, width)
    mask = (1 << width) - 1
    reg = init
    for byte in data:
        idx = ((reg >> (width - 8)) ^ byte) & 0xFF
        reg = ((reg << 8) ^ int(table[idx])) & mask
    return reg


def crc24_host(data: bytes) -> int:
    """Scalar host reference (oracle for the batched op)."""
    return _crc_host(data, CRC24_POLY, 24, CRC24_INIT)


def crc16_host(data: bytes) -> int:
    return _crc_host(data, CRC16_POLY, 16, CRC16_INIT)


def crc32_host(data: bytes) -> int:
    """Standard reflected CRC-32 (IEEE 802.3 / zlib-compatible)."""
    reg = CRC32_INIT
    for byte in data:
        reg ^= byte
        for _ in range(8):
            reg = (reg >> 1) ^ (CRC32_POLY_REFLECTED if reg & 1 else 0)
    return reg ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _crc_matrix(length: int, poly: int, width: int, init: int):
    """(F [8*length, width] float32, c0 bits [width] float32): column j of F
    is the CRC of the unit message with only bit j set and init 0; c0 is the
    CRC of the all-zero message with the real init."""
    rows = []
    for j in range(8 * length):
        msg = bytearray(length)
        msg[j // 8] = 0x80 >> (j % 8)  # MSB-first bit order within the byte
        rows.append(_crc_host(bytes(msg), poly, width, 0))
    c0 = _crc_host(bytes(length), poly, width, init)
    f = np.array(
        [[(r >> (width - 1 - b)) & 1 for b in range(width)] for r in rows],
        dtype=np.float32,
    )
    c0_bits = np.array(
        [(c0 >> (width - 1 - b)) & 1 for b in range(width)], dtype=np.float32
    )
    return f, c0_bits


def crc24_matrix(length: int) -> tuple[np.ndarray, np.ndarray]:
    """The CRC-24 (F, c0) pair for messages of ``length`` bytes."""
    return _crc_matrix(length, CRC24_POLY, 24, CRC24_INIT)


@functools.lru_cache(maxsize=None)
def _crc32_matrix(length: int):
    """The reflected CRC-32 is GF(2)-affine in the message bits too; bit j of
    byte i is its 2^j bit (LSB-first within the byte), and bit b of the
    result is its 2^b bit."""
    rows = []
    for j in range(8 * length):
        msg = bytearray(length)
        msg[j // 8] = 1 << (j % 8)
        rows.append(crc32_host(bytes(msg)) ^ crc32_host(bytes(length)))
    c0 = crc32_host(bytes(length))
    f = np.array([[(r >> b) & 1 for b in range(32)] for r in rows], dtype=np.float32)
    c0_bits = np.array([(c0 >> b) & 1 for b in range(32)], dtype=np.float32)
    return f, c0_bits


def _crc_apply(msg_bytes: torch.Tensor, key: str, matrix, msb_first: bool) -> torch.Tensor:
    """bits(m) @ F + c0 mod 2 over uint8 [..., L], packed into int64 [...]
    (torch has little arithmetic on uint32). ``msb_first`` orders the bits of
    each byte and of the result MSB-first; else LSB-first (reflected)."""
    length = msg_bytes.shape[-1]
    dev = msg_bytes.device
    f = device_const((key + "_f", length), lambda: matrix(length)[0], dev)
    c0 = device_const((key + "_c0", length), lambda: matrix(length)[1], dev)
    width = f.shape[-1]
    order = lambda n: np.arange(n)[::-1] if msb_first else np.arange(n)
    shifts = device_const((key + "_shifts",), lambda: order(8).astype(np.int32), dev)
    weights = device_const(
        (key + "_weights",), lambda: np.left_shift(1, order(width)).astype(np.int64), dev)
    bits = (msg_bytes.to(torch.int32)[..., None] >> shifts) & 1
    bits = bits.reshape(msg_bytes.shape[:-1] + (8 * length,)).to(torch.float32)
    crc_bits = torch.remainder(torch.remainder(bits @ f, 2.0) + c0, 2.0).to(torch.int64)
    return torch.sum(crc_bits * weights, dim=-1)


def crc24(msg_bytes: torch.Tensor) -> torch.Tensor:
    """CRC-24 over uint8 [..., L] -> int32 [...] (the value fits 24 bits;
    torch has little arithmetic on uint32)."""
    return _crc_apply(msg_bytes, "crc24", crc24_matrix, True).to(torch.int32)


def crc16(msg_bytes: torch.Tensor) -> torch.Tensor:
    """CRC-16/CCITT over uint8 [..., L] -> int32 [...]."""
    return _crc_apply(
        msg_bytes, "crc16", lambda n: _crc_matrix(n, CRC16_POLY, 16, CRC16_INIT), True
    ).to(torch.int32)


def crc32(msg_bytes: torch.Tensor) -> torch.Tensor:
    """Reflected CRC-32 (zlib-compatible) over uint8 [..., L] -> int64 [...]
    (the JAX package returns uint32; int64 holds every value)."""
    return _crc_apply(msg_bytes, "crc32", _crc32_matrix, False)


def crc24_append(msg_bytes: torch.Tensor) -> torch.Tensor:
    """Append the 3-byte big-endian CRC-24: [..., L] -> [..., L+3]."""
    c = crc24(msg_bytes)
    tail = torch.stack([(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF], dim=-1)
    return torch.cat([msg_bytes, tail.to(torch.uint8)], dim=-1)


def crc24_check(msg_with_crc: torch.Tensor) -> torch.Tensor:
    """Validate trailing CRC-24: [..., L+3] -> bool [...]."""
    body = msg_with_crc[..., :-3]
    tail = msg_with_crc[..., -3:].to(torch.int32)
    expect = (tail[..., 0] << 16) | (tail[..., 1] << 8) | tail[..., 2]
    return crc24(body) == expect
