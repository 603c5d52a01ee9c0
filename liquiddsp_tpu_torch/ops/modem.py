"""Linear modems: the reference's 11 constellations, batched mod/demod.

Modulation index space 0-10 -> {PSK2, PSK4, PSK8, PSK16, DPSK2, DPSK4, DPSK8,
ASK4, QAM16, QAM32, QAM64} exactly as the reference maps integers to liquid
schemes (lib/flex_tx_impl.cc:76-116; inverse map lib/flex_rx_impl.cc:139-179).

Symbol mappings are framework-defined (gray-coded PSK/ASK/QAM, cross QAM32;
liquid's exact tables are not replicated — TX and RX here share one table, so
loopback consistency holds by construction).

All constellations have unit average energy. Hard demodulation is a
minimum-distance search expressed as an inner-product score matrix.

Counterpart of ``liquiddsp_tpu/ops/modem.py``, all 11 modulations. The
differential (DPSK) schemes accumulate the phase steps over the last axis on
transmit and demodulate the step between neighbouring symbols on receive.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import MOD_BPS, Modulation
from liquiddsp_tpu_torch.core.device import device_const

_SQRT2 = np.sqrt(2.0)


def _gray_encode(x: np.ndarray) -> np.ndarray:
    return x ^ (x >> 1)


def _gray_decode_scalar(g: int) -> int:
    x = 0
    while g:
        x ^= g
        g >>= 1
    return x


def _pam_table(nbits: int) -> np.ndarray:
    """Gray-coded PAM levels for one axis: data m -> level, unit peak spacing 2."""
    n = 1 << nbits
    levels = (2.0 * np.arange(n) - (n - 1)).astype(np.float64)  # -n+1 .. n-1 step 2
    table = np.empty(n)
    for pos in range(n):
        table[_gray_encode(np.array(pos)).item()] = levels[pos]
    return table


def _psk_table(nbits: int, offset: float = 0.0) -> np.ndarray:
    m = 1 << nbits
    table = np.empty(m, dtype=np.complex128)
    for pos in range(m):
        data = _gray_encode(np.array(pos)).item()
        table[data] = np.exp(1j * (2.0 * np.pi * pos / m + offset))
    return table


@functools.lru_cache(maxsize=None)
def constellation(mod: int) -> np.ndarray:
    """Constellation table [2**bps] complex64, unit average energy.

    For DPSK schemes this is the *increment* constellation (the phase-step
    alphabet); absolute symbols are produced by differential accumulation.
    """
    mod = int(mod)
    if mod == Modulation.PSK2:
        t = np.array([1.0 + 0j, -1.0 + 0j])
    elif mod == Modulation.PSK4:
        # (+/-1 +/- 1j)/sqrt2; bits (b1 b0) -> (I sign, Q sign): naturally gray
        t = np.array(
            [1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], dtype=np.complex128
        ) / _SQRT2
    elif mod == Modulation.PSK8:
        t = _psk_table(3)
    elif mod == Modulation.PSK16:
        t = _psk_table(4)
    elif mod == Modulation.DPSK2:
        t = _psk_table(1)
    elif mod == Modulation.DPSK4:
        t = _psk_table(2)
    elif mod == Modulation.DPSK8:
        t = _psk_table(3)
    elif mod == Modulation.ASK4:
        t = _pam_table(2) / np.sqrt(5.0)
        t = t.astype(np.complex128)
    elif mod == Modulation.QAM16:
        pam = _pam_table(2)
        t = np.array([pam[m >> 2] + 1j * pam[m & 3] for m in range(16)]) / np.sqrt(10.0)
    elif mod == Modulation.QAM64:
        pam = _pam_table(3)
        t = np.array([pam[m >> 3] + 1j * pam[m & 7] for m in range(64)]) / np.sqrt(42.0)
    elif mod == Modulation.QAM32:
        # cross constellation: 6x6 grid minus the four corners, serpentine
        # index order (framework-defined mapping; liquid's QAM32 is also cross)
        pts = []
        axis = np.array([-5.0, -3.0, -1.0, 1.0, 3.0, 5.0])
        for r, q in enumerate(axis[::-1]):
            row = [complex(i, q) for i in axis if not (abs(i) == 5 and abs(q) == 5)]
            if r % 2:
                row = row[::-1]
            pts.extend(row)
        t = np.array(pts)
        t = t / np.sqrt(np.mean(np.abs(t) ** 2))
    else:
        raise ValueError(f"unknown modulation {mod}")
    assert len(t) == (1 << MOD_BPS[mod])
    # normalize average energy to exactly 1
    t = t / np.sqrt(np.mean(np.abs(t) ** 2))
    return t.astype(np.complex64)


def is_differential(mod: int) -> bool:
    return mod in (Modulation.DPSK2, Modulation.DPSK4, Modulation.DPSK8)


def rotational_symmetry(mod: int) -> float:
    """Smallest rotation (radians) mapping the constellation onto itself.

    A decision-directed phase estimate is only observable modulo this angle
    (a slip by it relabels every symbol consistently); carrier trackers must
    unwrap across observations with steps below half of it.
    """
    mod = int(mod)
    if mod in (Modulation.PSK2, Modulation.DPSK2, Modulation.ASK4):
        return float(np.pi)
    if mod == Modulation.PSK8 or mod == Modulation.DPSK8:
        return float(np.pi / 4)
    if mod == Modulation.PSK16:
        return float(np.pi / 8)
    # PSK4/DPSK4 and the square/cross QAMs are fourfold symmetric
    return float(np.pi / 2)


# ---------------------------------------------------------------------------
# bit <-> symbol-index packing (MSB-first)
# ---------------------------------------------------------------------------


def bits_to_indices(bits: torch.Tensor, bps: int) -> torch.Tensor:
    """Pack bits [..., n*bps] (int, MSB-first per symbol) -> indices [..., n]."""
    shape = bits.shape[:-1] + (bits.shape[-1] // bps, bps)
    b = bits.reshape(shape).to(torch.int32)
    weights = device_const(
        ("index_weights", bps), lambda: (1 << np.arange(bps - 1, -1, -1)).astype(np.int32),
        bits.device)
    return torch.sum(b * weights, dim=-1).to(torch.int32)


def indices_to_bits(idx: torch.Tensor, bps: int) -> torch.Tensor:
    """Unpack indices [..., n] -> bits [..., n*bps] (int8, MSB-first)."""
    shifts = device_const(
        ("index_shifts", bps), lambda: np.arange(bps - 1, -1, -1, dtype=np.int32), idx.device)
    bits = (idx.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(idx.shape[:-1] + (idx.shape[-1] * bps,)).to(torch.int8)


# ---------------------------------------------------------------------------
# modulate / demodulate
# ---------------------------------------------------------------------------


def constellation_t(mod: int, device: torch.device) -> torch.Tensor:
    """``constellation(mod)`` as a complex64 tensor on ``device``."""
    return device_const(("constellation", int(mod)), lambda: constellation(mod), device)


@functools.lru_cache(maxsize=None)
def _dpsk_tables(mod: int) -> tuple[np.ndarray, np.ndarray]:
    """For a differential scheme of M phases: the phase position of every
    gray-coded data value [M] int64, and the M absolute phases [M] complex64."""
    m = 1 << MOD_BPS[mod]
    pos_of_data = np.empty(m, dtype=np.int64)
    for pos in range(m):
        pos_of_data[_gray_encode(np.array(pos)).item()] = pos
    phases = np.exp(2j * np.pi * np.arange(m) / m).astype(np.complex64)
    return pos_of_data, phases


def modulate(indices: torch.Tensor, mod: int) -> torch.Tensor:
    """Symbol indices [..., n] -> complex64 symbols [..., n]."""
    dev = indices.device
    if not is_differential(mod):
        return constellation_t(mod, dev)[indices.to(torch.int64)]
    # differential: the phase position is the running sum of the steps mod M
    # over the last axis; the M phases come from a table, so that the symbols
    # are the same on every device
    pos_np, phases_np = _dpsk_tables(int(mod))
    steps = device_const(("dpsk_pos", int(mod)), lambda: pos_np, dev)[indices.to(torch.int64)]
    acc = torch.cumsum(steps, dim=-1) % len(pos_np)
    return device_const(("dpsk_phases", int(mod)), lambda: phases_np, dev)[acc]


def _decision_symbols(symbols: torch.Tensor, mod: int) -> torch.Tensor:
    """What the decision device sees: the symbols themselves, or for a
    differential scheme the unit-magnitude step from the symbol before (the
    first symbol steps from 1)."""
    if not is_differential(mod):
        return symbols
    prev = torch.cat([torch.ones_like(symbols[..., :1]), symbols[..., :-1]], dim=-1)
    z = symbols * torch.conj(prev)
    return z / torch.clamp(torch.abs(z), min=1e-12)


def demod_hard(symbols: torch.Tensor, mod: int) -> torch.Tensor:
    """Received symbols [..., n] -> hard symbol indices [..., n] (int32).

    Min-distance via score = Re(r conj(c)) - |c|^2/2, maximized over the
    constellation (first maximum wins, as ``argmax`` does in both packages).
    """
    table = constellation_t(mod, symbols.device)
    r = _decision_symbols(symbols, mod)
    scores = (
        r.real[..., None] * table.real
        + r.imag[..., None] * table.imag
        - 0.5 * (torch.abs(table) ** 2)
    )
    return torch.argmax(scores, dim=-1).to(torch.int32)


def demod_soft_bits(
    symbols: torch.Tensor, mod: int, noise_var: float | torch.Tensor = 0.1
) -> torch.Tensor:
    """Approximate per-bit LLRs [..., n*bps] (positive = bit 0 more likely).

    Max-log-MAP over the constellation: LLR_b = (min_{c:b=1}|r-c|^2 -
    min_{c:b=0}|r-c|^2) / noise_var. For DPSK the differential symbol is used.
    """
    table = constellation_t(mod, symbols.device)
    bps = MOD_BPS[mod]
    d2 = torch.abs(_decision_symbols(symbols, mod)[..., None] - table) ** 2  # [..., n, M]
    # zero_bit[b, m]: bit b (MSB first) of constellation index m is 0
    zero_bit = device_const(
        ("zero_bit", bps),
        lambda: ((np.arange(1 << bps)[None, :] >> np.arange(bps - 1, -1, -1)[:, None]) & 1) == 0,
        d2.device)
    inf = float("inf")
    llrs = []
    for b in range(bps):
        bit = zero_bit[b]
        d0 = torch.min(torch.where(bit, d2, inf), dim=-1).values
        d1 = torch.min(torch.where(~bit, d2, inf), dim=-1).values
        llrs.append((d1 - d0) / noise_var)
    return torch.stack(llrs, dim=-1).reshape(
        symbols.shape[:-1] + (symbols.shape[-1] * bps,)
    )
