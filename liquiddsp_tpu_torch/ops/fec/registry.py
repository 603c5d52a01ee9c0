"""FEC dispatch over the reference's inner/outer index spaces.

Outer index 0-7 -> {NONE, GOLAY2412, RS_M8, HAMMING74, HAMMING128,
SECDED2216, SECDED3932, SECDED7264}; inner index 0-6 -> {NONE, V27, V27P23,
V27P45, V27P56, V27P67, V27P78}. Counterpart of
``liquiddsp_tpu/ops/fec/registry.py``.

Pipeline position: payload bytes + CRC24 -> **outer** encode (bytes -> bits)
-> **inner** encode (bits -> bits) -> modulate. Bit-level block codes pad the
message bits with zeros to a whole number of blocks; the pad is dropped on
decode using the message byte length. Reed-Solomon (outer code 2) works on
bytes and splits the message into blocks of at most 223.
"""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.ops import bits as bitops
from liquiddsp_tpu_torch.ops.fec import block, conv, rs

_BLOCK_CODES = {
    1: block.golay2412,
    3: block.hamming74,
    4: block.hamming128,
    5: block.secded2216,
    6: block.secded3932,
    7: block.secded7264,
}


def _block_code(outer_code: int) -> block.LinearBlockCode:
    return _BLOCK_CODES[outer_code]()


def outer_encoded_bits(msg_len: int, outer_code: int) -> int:
    """Number of bits after outer-encoding ``msg_len`` bytes."""
    nbits = 8 * msg_len
    if outer_code == 0:
        return nbits
    if outer_code == 2:
        return 8 * rs.encoded_len(msg_len)
    c = _block_code(outer_code)
    return -(-nbits // c.k) * c.n


def outer_encode(msg_bytes: torch.Tensor, outer_code: int) -> torch.Tensor:
    """uint8 [..., L] -> coded bits int8 [..., outer_encoded_bits(L)]."""
    if outer_code == 2:
        return bitops.bytes_to_bits(rs.encode(msg_bytes))
    bits = bitops.bytes_to_bits(msg_bytes)
    if outer_code == 0:
        return bits
    c = _block_code(outer_code)
    pad = (-bits.shape[-1]) % c.k
    if pad:
        zeros = torch.zeros(bits.shape[:-1] + (pad,), dtype=bits.dtype, device=bits.device)
        bits = torch.cat([bits, zeros], dim=-1)
    return c.encode(bits)


def outer_decode(coded_bits: torch.Tensor, msg_len: int, outer_code: int) -> torch.Tensor:
    """Coded bits -> corrected message bytes uint8 [..., msg_len]."""
    if outer_code == 2:
        return rs.decode(bitops.bits_to_bytes(coded_bits), msg_len)
    if outer_code == 0:
        return bitops.bits_to_bytes(coded_bits[..., : 8 * msg_len])
    data_bits = _block_code(outer_code).decode(coded_bits)
    return bitops.bits_to_bytes(data_bits[..., : 8 * msg_len])


def inner_encoded_bits(nbits: int, inner_code: int) -> int:
    return conv.num_coded_bits(nbits, inner_code)


def inner_encode(bits: torch.Tensor, inner_code: int) -> torch.Tensor:
    return conv.encode(bits, inner_code)


def inner_decode(llrs: torch.Tensor, nbits: int, inner_code: int) -> torch.Tensor:
    """Soft-input inner decode: LLRs (positive = bit 0) -> bits."""
    return conv.decode(llrs, nbits, inner_code)
