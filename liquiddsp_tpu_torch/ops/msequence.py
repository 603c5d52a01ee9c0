"""Maximal-length LFSR sequences (m-sequences) and the flexframe p/n preamble.

Behavioral spec (framework-defined, matching the reference's documented use of
liquid-dsp ``msequence_create(7, 0x0089, 1)`` at
lib/frame_detector_cc_impl.cc:46-52):

- state register ``v`` of ``m`` bits, generator polynomial ``g`` whose bit i
  is the coefficient of x**i (0x0089 = x^7 + x^3 + 1, primitive), initial
  state ``a``.
- the feedback tap mask is ``g >> 1`` (the x^0 term drops out; tap i of the
  state corresponds to the x**(i+1) coefficient).
- one advance step emits ``b = popcount(v & (g >> 1)) & 1`` and updates
  ``v = ((v << 1) | b) & (2**m - 1)``.
- the flexframe preamble is 64 QPSK symbols; each symbol consumes two
  successive bits: real then imaginary, bit 1 -> +1/sqrt(2), bit 0 -> -1/sqrt(2)
  (lib/frame_detector_cc_impl.cc:49-50).

Sequence generation is a tiny, sequential, one-time host computation in
numpy; the resulting preamble is a constant table of the TX and the RX.
"""

from __future__ import annotations

import numpy as np

PREAMBLE_M = 7
PREAMBLE_G = 0x0089
PREAMBLE_A = 1
PREAMBLE_LEN = 64  # QPSK symbols


def msequence_bits(m: int, g: int, a: int, n: int) -> np.ndarray:
    """Generate ``n`` bits of the degree-``m`` LFSR sequence. Period 2**m - 1."""
    mask = (1 << m) - 1
    taps = g >> 1
    v = a & mask
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        b = bin(v & taps).count("1") & 1
        out[i] = b
        v = ((v << 1) | b) & mask
    return out


def preamble_symbols(n: int = PREAMBLE_LEN) -> np.ndarray:
    """The 64-symbol p/n QPSK preamble shared by TX, RX and the detector.

    Returns complex64 [n]. Two successive m-sequence bits map to one symbol
    (+/-1/sqrt(2) +/- 1j/sqrt(2)), as in lib/frame_detector_cc_impl.cc:46-52.
    """
    bits = msequence_bits(PREAMBLE_M, PREAMBLE_G, PREAMBLE_A, 2 * n).astype(np.float32)
    scale = np.float32(1.0 / np.sqrt(2.0))
    re = np.where(bits[0::2] > 0, scale, -scale)
    im = np.where(bits[1::2] > 0, scale, -scale)
    return (re + 1j * im).astype(np.complex64)
