"""Arbitrary-ratio resampling, batched: the liquid resamp_crcf analog.

Counterpart of ``arbitrary`` in ``liquiddsp_tpu/ops/resample.py`` with the
tables it is built from (``design_lowpass``, ``_frac_bank``, ``_bank_rows``,
``_bank_lowrank``, ``_lowrank_plan``). Output sample i reads input position
i / rate through a windowed-sinc fractional-delay filter. The index and tap
plans depend on the rate only, so they are numpy, built once per call; the
device work is one convolution and one gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def design_lowpass(cutoff: float, ntaps: int = 65) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, unit DC gain. cutoff in (0, 0.5]
    cycles/sample."""
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.kaiser(ntaps, 7.0)
    return (h / np.sum(h)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _frac_bank(num_phases: int, ntaps: int, cutoff: float) -> np.ndarray:
    """[num_phases, ntaps] fractional-delay low-pass bank (delay p/P)."""
    bank = []
    for ph in range(num_phases):
        n = np.arange(ntaps) - (ntaps - 1) / 2.0 - ph / num_phases
        h = 2 * cutoff * np.sinc(2 * cutoff * n)
        h *= np.kaiser(ntaps, 7.0)
        bank.append(h / np.sum(h))
    return np.asarray(bank, dtype=np.float32)


def _bank_rows(mu: np.ndarray, ntaps: int, cutoff: float) -> np.ndarray:
    """Exact fractional-delay tap rows at arbitrary delays ``mu`` in [0, 1):
    [len(mu), ntaps] (same windowed-sinc family as _frac_bank, no phase
    quantization)."""
    n = np.arange(ntaps)[None, :] - (ntaps - 1) / 2.0 - np.asarray(mu)[:, None]
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h = h * np.kaiser(ntaps, 7.0)[None, :]
    return (h / h.sum(axis=1, keepdims=True)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bank_lowrank(ntaps: int, cutoff: float, rank: int = 5,
                  fine: int = 1024) -> tuple[np.ndarray, float]:
    """Optimal low-rank factorization of the fractional-delay bank:
    bank(mu)[v] ~= sum_k w_k(mu) H[k, v] with H the top-``rank`` right
    singular vectors (orthonormal rows); the weights are the exact
    projections w(mu) = bank_row(mu) @ H.T. Returns (H [rank, ntaps],
    max-abs residual over a fine mu grid)."""
    bank = _frac_bank(fine, ntaps, cutoff)
    U, s, Vt = np.linalg.svd(bank, full_matrices=False)
    H = Vt[:rank]
    resid = float(np.abs((U[:, :rank] * s[:rank]) @ H - bank).max())
    return H.astype(np.float32), resid


def _lowrank_plan(rate: float, out_len: int, ntaps: int, cutoff: float,
                  H: np.ndarray):
    """Per-rate index/weight plan of the low-rank path: returns
    (w [out_len, rank] f32, d [out_len] int, segment bounds, Dmax), where
    output i reads the basis planes at i + d[i]."""
    pos = np.arange(out_len) / float(rate)
    base = np.floor(pos).astype(np.int64)
    mu = pos - base
    d = base - np.arange(out_len)
    runs = np.nonzero(np.diff(d))[0] + 1
    w = _bank_rows(mu, ntaps, cutoff) @ H.T  # [out_len, rank]
    return (w.astype(np.float32), d, [0, *runs.tolist(), out_len],
            int(abs(d).max()))


def _lowrank_apply(x: torch.Tensor, plan, H: np.ndarray, ntaps: int,
                   out_len: int) -> torch.Tensor:
    """Low-rank resample core: ONE convolution of ``x`` with the ``rank``
    basis filters (z_k = H[k] * x), then y[i] = sum_k w[i, k] z_k[i + d[i]]
    with the exact per-output fractional delay of ``plan``
    (_lowrank_plan), as one gather of the planes at i + d[i]."""
    w, d, _, dmax = plan
    half = (ntaps - 1) // 2
    dev = x.device
    xp = torch.nn.functional.pad(x, (half, ntaps + dmax + 1))
    cplx = x.is_complex()
    xf = torch.stack([xp.real, xp.imag]) if cplx else xp.to(torch.float32)[None]
    lead = xf.shape[:-1]
    # in float64: cuDNN takes a float32 convolution in TF32 by default, which
    # keeps about three digits
    hk = torch.from_numpy(np.ascontiguousarray(H)).to(dev, torch.float64)[:, None, :]
    z = torch.nn.functional.conv1d(
        xf.reshape(-1, 1, xf.shape[-1]).to(torch.float64), hk).to(torch.float32)  # [P*B, rank, M]
    idx = torch.from_numpy(np.arange(out_len) + d).to(dev)
    zg = z.index_select(-1, idx)  # [P*B, rank, out_len]
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).to(dev)  # [rank, out_len]
    y = torch.sum(zg * wt, dim=-2).reshape(lead + (out_len,))
    if cplx:
        return torch.complex(y[0], y[1]).to(x.dtype)
    return y[0].to(x.dtype)


def arbitrary(x: torch.Tensor, rate: float, out_len: int, num_phases: int = 32,
              ntaps: int = 33) -> torch.Tensor:
    """Arbitrary-ratio resample: y[i] = x(i / rate), [..., T] -> [..., out_len].

    Near-unity rates (ppm clock offsets: at most 256 runs of a constant
    integer offset) take the low-rank Farrow structure: ``rank`` fixed-tap
    convolutions and a per-output combine with the exact fractional delay.
    Other rates take nearest-of-``num_phases`` polyphase interpolation as a
    gather of [..., out_len, ntaps] windows.
    """
    cutoff = 0.5 * min(1.0, rate)
    pos = np.arange(out_len) / rate  # input-domain positions
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    phase_r = np.round(frac * num_phases).astype(np.int64)
    base = base + phase_r // num_phases
    phase = phase_r % num_phases
    d = base - np.arange(out_len)  # integer shift per output
    runs = np.nonzero(np.diff(d))[0] + 1
    if len(runs) + 1 <= 256:
        H, resid = _bank_lowrank(ntaps, cutoff)
        if resid < 1e-3:
            plan = _lowrank_plan(rate, out_len, ntaps, cutoff, H)
            return _lowrank_apply(x, plan, H, ntaps, out_len)
    # the nearest-phase stencil: every output reads its own window
    half = (ntaps - 1) // 2
    dev = x.device
    taps = torch.from_numpy(_frac_bank(num_phases, ntaps, cutoff)[phase]).to(dev)
    xp = torch.nn.functional.pad(x, (half, ntaps + int(abs(d).max()) + 1))
    idx = torch.from_numpy(base[:, None] + np.arange(ntaps)[None, :]).to(dev)
    windows = xp[..., idx]  # [..., out_len, ntaps]
    return torch.sum(windows * taps, dim=-1)
