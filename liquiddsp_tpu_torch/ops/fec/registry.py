"""FEC dispatch over the reference's inner/outer index spaces.

Outer index 0-7 -> {NONE, GOLAY2412, RS_M8, HAMMING74, HAMMING128,
SECDED2216, SECDED3932, SECDED7264}; inner index 0-6 -> {NONE, V27, V27P23,
V27P45, V27P56, V27P67, V27P78}. Counterpart of
``liquiddsp_tpu/ops/fec/registry.py``.

Pipeline position: payload bytes + CRC24 -> **outer** encode (bytes -> bits)
-> **inner** encode (bits -> bits) -> modulate. Bit-level block codes pad the
message bits with zeros to a whole number of blocks; the pad is dropped on
decode using the message byte length.

The *length* functions are integer arithmetic and cover every code, so that
``FrameSpec`` is right for all 616 configs. Encode/decode of Reed-Solomon,
Hamming and SEC-DED are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.ops import bits as bitops
from liquiddsp_tpu_torch.ops.fec import block, conv

# (n, k) of the bit-level outer block codes
BLOCK_NK = {1: (24, 12), 3: (7, 4), 4: (12, 8), 5: (22, 16), 6: (39, 32), 7: (72, 64)}

RS_KK = 223  # Reed-Solomon data bytes per full block
RS_NROOTS = 32  # parity bytes per block


def rs_block_sizes(msg_len: int) -> list[int]:
    """Split a message of ``msg_len`` bytes into near-equal blocks <= 223."""
    nb = -(-msg_len // RS_KK)
    base, rem = divmod(msg_len, nb)
    return [base + (1 if i < rem else 0) for i in range(nb)]


def rs_encoded_len(msg_len: int) -> int:
    return msg_len + RS_NROOTS * len(rs_block_sizes(msg_len))


def _block_code(outer_code: int) -> block.LinearBlockCode:
    if outer_code == 1:
        return block.golay2412()
    raise NotImplementedError(f"outer code {outer_code} is not ported yet")


def outer_encoded_bits(msg_len: int, outer_code: int) -> int:
    """Number of bits after outer-encoding ``msg_len`` bytes."""
    nbits = 8 * msg_len
    if outer_code == 0:
        return nbits
    if outer_code == 2:
        return 8 * rs_encoded_len(msg_len)
    n, k = BLOCK_NK[outer_code]
    return -(-nbits // k) * n


def outer_encode(msg_bytes: torch.Tensor, outer_code: int) -> torch.Tensor:
    """uint8 [..., L] -> coded bits int8 [..., outer_encoded_bits(L)]."""
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
