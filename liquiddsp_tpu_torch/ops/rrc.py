"""Root-Nyquist pulse-shape design (RRC family) + polyphase fractional-delay banks.

The reference pins the pulse to liquid's ``LIQUID_FIRFILT_ARKAISER`` with
k=2 samples/symbol, m=7 symbol delay, beta=0.3 rolloff
(lib/frame_detector_cc_impl.cc:54, lib/frame_detector_cc_impl.h:34-36), used
identically by the TX interpolator, the RX matched filter and the detector
template. liquid's ARKAISER is an approximate-Kaiser root-Nyquist design; this
framework uses the exact root-raised-cosine (``rrcos``) as its default pulse
and offers a Kaiser-windowed variant (``arkaiser``). TX, RX and detector all
share one design, so matched-filter consistency holds by construction.

Tap design is a one-time host computation in numpy.
"""

from __future__ import annotations

import functools

import numpy as np

K = 2  # samples per symbol
M = 7  # filter semi-length in symbols
BETA = 0.3  # rolloff

# filter length for (k, m): 2*k*m + 1 taps
FILTER_DELAY_SAMPLES = K * M  # group delay of one filter, in samples


def rrcos_taps(k: int = K, m: int = M, beta: float = BETA, dt: float = 0.0) -> np.ndarray:
    """Root-raised-cosine taps, length 2*k*m+1, unit energy.

    ``dt`` is a fractional sample offset (in samples) for polyphase
    fractional-delay banks; dt=0 gives the symmetric prototype.
    """
    n = np.arange(-k * m, k * m + 1, dtype=np.float64) - dt
    t = n / k  # time in symbol units
    h = np.empty_like(t)
    eps = 1e-9
    # singularities: t == 0 and |t| == 1/(4 beta)
    t0 = np.abs(t) < eps
    ts = np.abs(np.abs(t) - 1.0 / (4.0 * beta)) < eps
    tn = ~(t0 | ts)
    tt = t[tn]
    h[tn] = (
        np.sin(np.pi * tt * (1.0 - beta))
        + 4.0 * beta * tt * np.cos(np.pi * tt * (1.0 + beta))
    ) / (np.pi * tt * (1.0 - (4.0 * beta * tt) ** 2))
    h[t0] = 1.0 - beta + 4.0 * beta / np.pi
    h[ts] = (beta / np.sqrt(2.0)) * (
        (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
        + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta))
    )
    return (h / np.sqrt(np.sum(h * h))).astype(np.float32)


def arkaiser_taps(k: int = K, m: int = M, beta: float = BETA, dt: float = 0.0) -> np.ndarray:
    """Kaiser-windowed RRC — this framework's ARKAISER-flavored variant."""
    h = rrcos_taps(k, m, beta, dt).astype(np.float64)
    w = np.kaiser(len(h), 2.0)
    h = h * w
    return (h / np.sqrt(np.sum(h * h))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def matched_taps(k: int = K, m: int = M, beta: float = BETA, ftype: str = "rrcos") -> np.ndarray:
    """The shared TX/RX/detector pulse, length 2*k*m+1, unit energy."""
    if ftype == "rrcos":
        return rrcos_taps(k, m, beta)
    if ftype == "arkaiser":
        return arkaiser_taps(k, m, beta)
    raise ValueError(f"unknown filter type {ftype!r}")


@functools.lru_cache(maxsize=None)
def fractional_delay_bank(
    num_phases: int = 32, k: int = K, m: int = M, beta: float = BETA, ftype: str = "rrcos"
) -> np.ndarray:
    """Bank of fractional-delay matched filters [num_phases, 2*k*m+1].

    bank[p] is the pulse delayed by p/num_phases of a sample — the RX symbol
    timing-recovery analog of liquid's polyphase filterbank inside
    ``flexframesync`` (SURVEY.md section 2.2, AGC/NCO/symbol-sync row).
    Convolving with bank[p] instead of bank[0] shifts the effective sampling
    instant by +p/num_phases samples.
    """
    fn = rrcos_taps if ftype == "rrcos" else arkaiser_taps
    bank = np.stack([fn(k, m, beta, dt=p / num_phases) for p in range(num_phases)])
    return bank.astype(np.float32)
