"""The flexframe frame format: geometry as a pure function of config.

Counterpart of ``liquiddsp_tpu/phy/frame_spec.py`` (numpy only).

Frame structure (this framework's spec; role-equivalent to liquid-dsp's
flexframe as pinned by the reference — SURVEY.md section 2.2 flexframegen row):

    [ preamble | header | payload ]  -> RRC-interpolated at k=2

- preamble: 64 QPSK symbols from msequence(7, 0x0089, 1)
  (lib/frame_detector_cc_impl.cc:46-52) — also the detector template.
- header: self-describing, fixed robust scheme: 14 user bytes
  (lib/flex_tx_impl.cc:58-59) + 5 protocol bytes (payload_len u16 BE,
  modulation u8, inner u8, outer u8) + CRC-24 = 22 bytes = 176 bits,
  zero-padded to 180, Golay(24,12)-encoded to 360 bits, QPSK -> 180 symbols.
  The RX reads payload modem/FEC from the decoded header, mirroring
  flexframesync's self-describing frames (lib/flex_rx_impl.cc:232-234).
- payload: payload bytes + CRC-24 (LIQUID_CRC_24 analog,
  lib/flex_tx_impl.cc:52) -> outer FEC -> inner FEC -> bit interleave ->
  modulate with the configured modem.
- samples: 'full' RRC interpolation, so
  frame_samples = k*frame_syms + (2*k*m + 1) - 1 = 2*frame_syms + 28.

All lengths are fixed per (modulation, inner, outer, payload_len): shapes
never depend on data.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from liquiddsp_tpu_torch.core.config import MOD_BPS, FrameConfig, Modulation
from liquiddsp_tpu_torch.ops import rrc
from liquiddsp_tpu_torch.ops.fec import registry

PREAMBLE_SYMS = 64
HEADER_USER_BYTES = 14  # lib/flex_tx_impl.cc:58
HEADER_PROTO_BYTES = 5  # payload_len u16, mod u8, inner u8, outer u8
HEADER_BYTES = HEADER_USER_BYTES + HEADER_PROTO_BYTES + 3  # + CRC24 = 22
HEADER_BITS = 8 * HEADER_BYTES  # 176
HEADER_BITS_PADDED = 180  # multiple of golay k=12
HEADER_CODED_BITS = HEADER_BITS_PADDED * 2  # golay rate 1/2 -> 360
HEADER_SYMS = HEADER_CODED_BITS // 2  # QPSK -> 180
HEADER_MOD = int(Modulation.PSK4)

CRC_BYTES = 3
K_SAMP = rrc.K  # 2 samples/symbol
PULSE_LEN = 2 * rrc.K * rrc.M + 1  # 29 taps
PULSE_TAIL = PULSE_LEN - 1  # 28 extra samples from 'full' convolution

INTERLEAVE_DEPTH = 16


@functools.lru_cache(maxsize=None)
def interleave_perm(n: int, depth: int = INTERLEAVE_DEPTH) -> np.ndarray:
    """Rectangular bit interleaver permutation of length n (row-write,
    column-read over a depth x ceil(n/depth) grid, skipping the ragged tail).

    out[i] = in[perm[i]]. Static per coded length; applied after inner
    encoding so symbol-burst errors spread across Viterbi branches.
    """
    cols = -(-n // depth)
    idx = np.arange(depth * cols).reshape(depth, cols)
    order = idx.T.reshape(-1)
    order = order[order < n]
    # order lists input positions in output order
    return order.astype(np.int32)


@functools.lru_cache(maxsize=None)
def interleave_inv(n: int, depth: int = INTERLEAVE_DEPTH) -> np.ndarray:
    perm = interleave_perm(n, depth)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=np.int32)
    return inv


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """Static frame geometry for one (modulation, inner, outer, payload_len)."""

    cfg: FrameConfig

    @property
    def bps(self) -> int:
        return MOD_BPS[self.cfg.modulation]

    @property
    def payload_msg_bytes(self) -> int:
        return self.cfg.payload_len + CRC_BYTES

    @property
    def outer_bits(self) -> int:
        return registry.outer_encoded_bits(self.payload_msg_bytes, self.cfg.outer_code)

    @property
    def inner_bits(self) -> int:
        return registry.inner_encoded_bits(self.outer_bits, self.cfg.inner_code)

    @property
    def payload_syms(self) -> int:
        return -(-self.inner_bits // self.bps)

    @property
    def payload_pad_bits(self) -> int:
        return self.payload_syms * self.bps - self.inner_bits

    @property
    def frame_syms(self) -> int:
        return PREAMBLE_SYMS + HEADER_SYMS + self.payload_syms

    @property
    def frame_samples(self) -> int:
        return K_SAMP * self.frame_syms + PULSE_TAIL

    # symbol offsets within the frame
    @property
    def header_sym_offset(self) -> int:
        return PREAMBLE_SYMS

    @property
    def payload_sym_offset(self) -> int:
        return PREAMBLE_SYMS + HEADER_SYMS


@functools.lru_cache(maxsize=None)
def max_frame_spec(payload_len: int) -> FrameSpec:
    """The longest frame over all 616 configs at this payload length, which
    sizes a receiver's symbol buffer. The worst outer code depends on the
    payload length (Golay, rate 1/2, for long payloads; Reed-Solomon's 32
    parity bytes below about 30 bytes), so all 56 (inner, outer) pairs of
    BPSK, the modulation with the fewest bits a symbol, are scanned."""
    return max(
        (
            FrameSpec(FrameConfig(0, i, o, payload_len))
            for i in range(7)
            for o in range(8)
        ),
        key=lambda s: s.frame_syms,
    )
