"""Polyphase resampling, batched: BASELINE config 3's "per-channel
polyphase resampling" and the liquid firinterp/firdecim/resamp analog.

Counterpart of ``liquiddsp_tpu/ops/resample.py``:

- ``interp(x, p, taps)``: integer upsampling by P (zero-stuff + anti-image
  filter).
- ``decim(x, q, taps)``: integer decimation by Q with an anti-alias filter.
- ``rational(x, p, q, taps)``: rational P/Q resampling (interpolate, then
  take every Q-th sample).
- ``arbitrary(x, rate, out_len)``: y[i] = x(i / rate) through a
  windowed-sinc fractional-delay filter.
- ``arbitrary_groups(x, rates, out_len)``: ``arbitrary`` per equal group of
  channels along axis 0, sharing one filter pass.
- ``design_lowpass``: windowed-sinc anti-alias prototype.

The index and tap plans depend on the rate only, so they are numpy; those of
the near-unity path are kept per rate and length, with their device copies,
each in a cache of at most 64 entries.
The device work of that path is one convolution with the low-rank basis and
one gather-and-combine per group.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from liquiddsp_tpu_torch.ops import fir


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


def interp(x: torch.Tensor, p: int, taps: np.ndarray | None = None) -> torch.Tensor:
    """[..., T] -> [..., p*T] complex64: zero-stuff + anti-image filter (gain p)."""
    if taps is None:
        taps = design_lowpass(0.5 / p) * p
    y = fir.interp_full(x, taps, p)
    delay = (len(taps) - 1) // 2
    return y[..., delay : delay + p * x.shape[-1]]


def decim(x: torch.Tensor, q: int, taps: np.ndarray | None = None) -> torch.Tensor:
    """[..., T] -> [..., ceil(T / q)]: anti-alias filter + take every q-th."""
    if taps is None:
        taps = design_lowpass(0.5 / q)
    return fir.conv_same(x, taps)[..., ::q]


def rational(x: torch.Tensor, p: int, q: int, taps: np.ndarray | None = None) -> torch.Tensor:
    """[..., T] -> [..., ceil(p*T / q)] complex64: resample by p/q."""
    if taps is None:
        taps = design_lowpass(0.5 / max(p, q)) * p
    up = fir.interp_full(x, taps, p)
    delay = (len(taps) - 1) // 2
    return up[..., delay : delay + p * x.shape[-1]][..., ::q]


def plane_conv(rows: torch.Tensor, H: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The low-rank basis planes of float32 rows [N, 1, M_in]: z[:, k, m] =
    sum_v H[k, v] rows[:, 0, m + v] -> [N, rank, M_in - ntaps + 1] in
    ``dtype`` (operands and planes; float32 with TF32 off on the GPU)."""
    hk = torch.from_numpy(np.ascontiguousarray(H)).to(rows.device, dtype)[:, None, :]
    if dtype == torch.float32:
        return fir.conv1d_f32(rows, hk)
    return torch.nn.functional.conv1d(rows.to(dtype), hk)


@functools.lru_cache(maxsize=64)
def _cached_plan(rate: float, out_len: int, ntaps: int, cutoff: float, rank: int):
    """``_lowrank_plan`` of one rate against the rank-``rank`` basis, kept:
    it evaluates a windowed sinc per output and tap on the host."""
    return _lowrank_plan(rate, out_len, ntaps, cutoff, _bank_lowrank(ntaps, cutoff, rank)[0])


@functools.lru_cache(maxsize=64)
def _device_plan(key: tuple, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The plan ``_cached_plan(*key)`` on ``device``: (gather index [out_len],
    combine weights [rank, out_len]), in a cache as bounded as the plans'."""
    w, d, _, _ = _cached_plan(*key)
    idx = torch.from_numpy(np.arange(key[1]) + d).to(device)
    return idx, torch.from_numpy(np.ascontiguousarray(w.T)).to(device)


def lowrank_operands(x: torch.Tensor, rates, out_len: int, ntaps: int, cutoff: float,
                     rank: int) -> tuple[torch.Tensor, np.ndarray]:
    """The plane convolution's operands in the low-rank core for ``rates``:
    float32 rows [P * N, 1, M] (P = 2 real/imaginary planes for complex
    ``x``, N its leading elements), each padded by ``(ntaps - 1) // 2``
    before and ``ntaps`` + the plans' largest integer offset + 1 after, and
    the basis H [rank, ntaps]."""
    dmax = max(_cached_plan(float(r), out_len, ntaps, cutoff, rank)[3] for r in rates)
    xp = torch.nn.functional.pad(x, ((ntaps - 1) // 2, ntaps + dmax + 1))
    xf = torch.stack([xp.real, xp.imag]) if x.is_complex() else xp.to(torch.float32)[None]
    return xf.reshape(-1, 1, xf.shape[-1]), _bank_lowrank(ntaps, cutoff, rank)[0]


def _lowrank_apply(x: torch.Tensor, rates, out_len: int, ntaps: int, cutoff: float,
                   rank: int, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Shared low-rank resample core: ONE convolution of ``x`` with the
    ``rank`` basis filters (z_k = H[k] * x), then per group y[i] = sum_k
    w[i, k] z_k[i + d[i]] with the exact per-output fractional delay of its
    rate's plan (_lowrank_plan), as one gather of the planes at i + d[i] and
    a combine accumulated in float32. ``rates`` holds one rate per equal
    contiguous group along axis 0.

    ``compute_dtype=torch.bfloat16`` gives the convolution bf16 operands and
    stores the planes in bf16: the planes are the memory traffic of the
    whole path, for a quantisation floor far under any operating SNR of the
    receiver's front end."""
    keys = [(float(r), out_len, ntaps, cutoff, rank) for r in rates]
    rows, H = lowrank_operands(x, rates, out_len, ntaps, cutoff, rank)
    z = plane_conv(rows, H, compute_dtype or torch.float32)
    cplx = x.is_complex()
    z = z.reshape((2 if cplx else 1,) + x.shape[:-1] + z.shape[-2:])  # [P, ..., rank, M]
    gsz = x.shape[0] // len(keys) if x.dim() > 1 else 1
    ys = []
    for gi, key in enumerate(keys):
        zg = z[:, gi * gsz : (gi + 1) * gsz] if len(keys) > 1 else z
        idx, wt = _device_plan(key, str(x.device))
        ys.append(torch.sum(zg.index_select(-1, idx).to(torch.float32) * wt, dim=-2))
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    if cplx:
        return torch.complex(y[0], y[1]).to(x.dtype)
    return y[0].to(x.dtype)


def arbitrary(x: torch.Tensor, rate: float, out_len: int, num_phases: int = 32,
              ntaps: int = 33, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Arbitrary-ratio resample: y[i] = x(i / rate), [..., T] -> [..., out_len].

    Near-unity rates (ppm clock offsets: at most 256 runs of a constant
    integer offset) take the low-rank Farrow structure: ``rank`` fixed-tap
    convolutions (in ``compute_dtype``, float32 by default) and a per-output
    combine with the exact fractional delay. Other rates, and a bank too
    sharp to factor, take nearest-of-``num_phases`` polyphase interpolation:
    as one shifted multiply-add a tap per run of a constant integer offset
    where there are at most 32 runs, else as a gather of [..., out_len,
    ntaps] windows.
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
        if _bank_lowrank(ntaps, cutoff)[1] < 1e-3:
            return _lowrank_apply(x, [rate], out_len, ntaps, cutoff, 5, compute_dtype)
    # the nearest-phase stencil: every output reads its own window
    half = (ntaps - 1) // 2
    dev = x.device
    taps_np = _frac_bank(num_phases, ntaps, cutoff)[phase]  # [out_len, ntaps]
    xp = torch.nn.functional.pad(x, (half, ntaps + int(abs(d).max()) + 1))
    if len(runs) + 1 <= 32:
        # per run d is constant, so every tap reads one slice of xp
        taps_t = torch.from_numpy(np.ascontiguousarray(taps_np.T)).to(dev)  # [ntaps, out_len]
        bounds = [0, *runs.tolist(), out_len]
        segs = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            dv = int(d[a])
            y = torch.zeros(x.shape[:-1] + (b - a,), dtype=x.dtype, device=dev)
            for v in range(ntaps):
                y = y + xp[..., a + dv + v : b + dv + v] * taps_t[v, a:b]
            segs.append(y)
        return torch.cat(segs, dim=-1)
    idx = torch.from_numpy(base[:, None] + np.arange(ntaps)[None, :]).to(dev)
    windows = xp[..., idx]  # [..., out_len, ntaps]
    return torch.sum(windows * torch.from_numpy(taps_np).to(dev), dim=-1)


def arbitrary_groups(x: torch.Tensor, rates, out_len: int, ntaps: int = 33,
                     compute_dtype: torch.dtype | None = None, rank: int = 5) -> torch.Tensor:
    """Per-channel-group arbitrary resampling sharing ONE filter pass.

    ``x`` is ``[G*g, ..., T]``: ``len(rates)`` equal contiguous groups along
    axis 0; group ``i`` is resampled by ``rates[i]`` (BASELINE config 3: 64
    channels split into ppm clock-offset groups). For near-unity rates the
    low-rank basis depends only on the anti-alias cutoff, so one convolution
    over all channels serves every group; only the per-group combine
    differs. Falls back to per-group :func:`arbitrary` calls (with the same
    ``ntaps`` and ``compute_dtype``) for any rate more than 1e-3 from unity,
    a bank too sharp for ``rank`` planes, or more than 256 integer-shift
    runs. 1-D input is one channel and takes one rate.
    """
    G = len(rates)
    if x.dim() < 2 and G > 1:
        raise ValueError(f"1-D input is one channel: {G} rates given")
    if x.shape[0] % G:
        raise ValueError(f"batch {x.shape[0]} not divisible into {G} groups")

    def _fallback():
        g = x.shape[0] // G
        parts = [arbitrary(x[i * g : (i + 1) * g], float(r), out_len, ntaps=ntaps,
                           compute_dtype=compute_dtype) for i, r in enumerate(rates)]
        return torch.cat(parts, dim=0)

    if any(abs(float(r) - 1.0) > 1e-3 for r in rates):
        return _fallback()
    # the most conservative anti-alias across the groups: at ppm rates the
    # per-rate cutoffs differ by O(ppm), far below the bank's stop-band floor
    cutoff = 0.5 * min(1.0, min(float(r) for r in rates))
    # rank 5 holds the 1e-3 (-60 dB) gate; rank 4 lands at about 1.5e-3 for
    # one plane fewer, still far below the bf16 storage floor
    if _bank_lowrank(ntaps, cutoff, rank)[1] >= (2e-3 if rank == 4 else 1e-3):
        return _fallback()
    if any(len(_cached_plan(float(r), out_len, ntaps, cutoff, rank)[2]) - 1 > 256 for r in rates):
        return _fallback()
    return _lowrank_apply(x, rates, out_len, ntaps, cutoff, rank, compute_dtype)
