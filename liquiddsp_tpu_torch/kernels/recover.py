"""Fused NCO derotation + polyphase matched filter + decimation by 2.

Symbol recovery is, per candidate window, a complex NCO rotation followed by
a 30-tap filter-and-decimate:

    y[s] = sum_v  (win[2s+v] * e^{-j(dphi*(2s+v)+phi)} / max(gamma, 1e-9)) * t[v]

with t the candidate's row of ``framesync._timing_bank30``.

``recover_symbols_planes`` launches the CUDA kernel ``csrc/recover.cu`` for
CUDA tensors (the counterpart of ``recover_symbols_planes`` in
``liquiddsp_tpu/kernels/recover.py``) and takes
``recover_symbols_planes_ref`` only for CPU tensors. It reads the float32
planes of ``kernels.extract.extract_windows`` directly.

The kernel gives a block of 128 threads a tile of up to 512 output symbols of
one candidate, 4 consecutive symbols a thread. What it decides in index
arithmetic is written here as pure functions that the CPU tests hold and the
``.cu`` source names: ``recover_tile`` (the wrapper hands its result to the
kernel) and ``load_width``.
"""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.kernels import _cuda

N_TAPS = 30  # PULSE_LEN + 1 (framesync._timing_bank30 rows)
SYMS_PER_THREAD = 4
MAX_TILE = 512  # output symbols of one block: 128 threads x 4


def recover_tile(n_syms: int) -> tuple[int, int]:
    """(tile, blocks): a candidate's ``n_syms`` output symbols are cut into
    the fewest blocks of at most ``MAX_TILE`` symbols, and those blocks are
    made equal, so that the last one is not mostly empty (1330 symbols: 3
    blocks of 444, not 2 of 512 and one of 306). The tile is a multiple of 4:
    a thread owns 4 consecutive symbols, and a tile then starts on a multiple
    of 8 samples, which keeps a row's 16-byte phase."""
    if n_syms < 1:
        raise ValueError(f"n_syms must be positive, got {n_syms}")
    blocks = -(-n_syms // MAX_TILE)
    per_block = -(-n_syms // blocks)
    tile = -(-per_block // SYMS_PER_THREAD) * SYMS_PER_THREAD
    return tile, -(-n_syms // tile)


def load_width(byte_address: int) -> int:
    """Bytes of the widest load that is legal for 4 consecutive float32 at
    ``byte_address``: 16, else two of 8, else four of 4. Window rows have
    n = 2 * n_syms + 28 samples, so with an odd ``n_syms`` every other
    candidate's row starts on an 8-byte phase."""
    return 16 if byte_address % 16 == 0 else 8 if byte_address % 8 == 0 else 4


def recover_symbols_planes_ref(
    wr: torch.Tensor,
    wi: torch.Tensor,
    dphi: torch.Tensor,
    phi: torch.Tensor,
    gamma: torch.Tensor,
    taps30: torch.Tensor,
    n_syms: int,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic (dense sin/cos of
    dphi*m + phi, ascending tap order)."""
    n = wr.shape[-1]
    m = torch.arange(n, dtype=torch.float32, device=wr.device)
    th = dphi[..., None] * m + phi[..., None]
    c, s = torch.cos(th), torch.sin(th)
    ig = (1.0 / torch.clamp(gamma, min=1e-9))[..., None]
    dr = (wr * c + wi * s) * ig
    di = (wi * c - wr * s) * ig
    yr = torch.zeros(wr.shape[:-1] + (n_syms,), dtype=torch.float32, device=wr.device)
    yi = torch.zeros_like(yr)
    for v in range(N_TAPS):
        tv = taps30[..., v, None]
        yr = yr + dr[..., v : v + 2 * n_syms : 2] * tv
        yi = yi + di[..., v : v + 2 * n_syms : 2] * tv
    return torch.complex(yr, yi)


def recover_symbols_planes(
    wr: torch.Tensor,
    wi: torch.Tensor,
    dphi: torch.Tensor,
    phi: torch.Tensor,
    gamma: torch.Tensor,
    taps30: torch.Tensor,
    n_syms: int,
    stamps: torch.Tensor | None = None,
) -> torch.Tensor:
    """wr/wi [B, K, n] float32 window planes (n >= 2*n_syms + 28); dphi, phi,
    gamma [B, K] float32; taps30 [B, K, 30] float32 -> [B, K, n_syms]
    complex64 symbol estimates.

    ``stamps``, where given, is a [B * K * blocks, 3] int64 CUDA tensor
    (``blocks`` of ``recover_tile``) into which each block writes its SM's
    ``clock64()`` at its start, after the derotation and after the filter."""
    b, k, n = wr.shape
    if n < 2 * n_syms + N_TAPS - 2:
        raise ValueError(f"window of {n} samples is too short for {n_syms} symbols")
    if not wr.is_cuda:
        return recover_symbols_planes_ref(wr, wi, dphi, phi, gamma, taps30, n_syms)
    _cuda.check_cuda("wr", wr, torch.float32, (b, k, n))
    _cuda.check_cuda("wi", wi, torch.float32, (b, k, n))
    for name, v in (("dphi", dphi), ("phi", phi), ("gamma", gamma)):
        _cuda.check_cuda(name, v, torch.float32, (b, k))
    _cuda.check_cuda("taps30", taps30, torch.float32, (b, k, N_TAPS))
    tile, blocks = recover_tile(n_syms)
    if stamps is not None:
        _cuda.check_cuda("stamps", stamps, torch.int64, (b * k * blocks, 3))
    y = torch.empty((b, k, n_syms), dtype=torch.complex64, device=wr.device)
    _cuda.launch(
        "recover", "lq_recover_symbols", wr.device,
        wr.data_ptr(), wi.data_ptr(), dphi.data_ptr(), phi.data_ptr(),
        gamma.data_ptr(), taps30.data_ptr(), y.data_ptr(),
        None if stamps is None else stamps.data_ptr(), b * k, n, n_syms, tile,
    )
    return y
