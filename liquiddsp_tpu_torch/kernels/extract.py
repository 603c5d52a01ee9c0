"""Batched variable-offset window extraction.

The RX pipeline needs "K windows of n samples at per-candidate start offsets"
from each stream row: candidate frame windows for symbol recovery and
preamble windows for the fine CFO estimate. Samples outside [0, T) read as
zero. Exact.

``extract_windows`` launches the CUDA kernel ``csrc/extract.cu`` for a CUDA
tensor (the counterpart of ``extract_windows`` in
``liquiddsp_tpu/kernels/extract.py``; the planes carry exactly n samples, no
lane padding) and takes ``extract_windows_ref`` only for a CPU tensor.
"""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.kernels import _cuda


def extract_windows_ref(
    x: torch.Tensor, starts: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: x [B, T] complex64, starts [B, K] int32 ->
    (real, imag) float32 planes [B, K, n]."""
    t = x.shape[-1]
    idx = starts.to(torch.int64)[..., None] + torch.arange(n, device=x.device)
    valid = (idx >= 0) & (idx < t)
    idx = idx.clamp(0, t - 1)
    xr = torch.view_as_real(x.to(torch.complex64))  # [B, T, 2]
    b, k = starts.shape
    flat = idx.reshape(b, k * n)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    wr = torch.where(valid, torch.gather(xr[..., 0], 1, flat).reshape(b, k, n), zero)
    wi = torch.where(valid, torch.gather(xr[..., 1], 1, flat).reshape(b, k, n), zero)
    return wr, wi


def extract_windows(
    x: torch.Tensor, starts: torch.Tensor, n: int, return_planes: bool = False
):
    """x [B, T] complex64, starts [B, K] int32 -> windows [B, K, n]
    complex64, or with ``return_planes`` the (real, imag) float32 planes the
    symbol-recovery kernel reads directly."""
    if not x.is_cuda:
        wr, wi = extract_windows_ref(x, starts, n)
    else:
        b, t = x.shape
        k = starts.shape[1]
        _cuda.check_cuda("x", x, torch.complex64, (b, t))
        _cuda.check_cuda("starts", starts, torch.int32, (b, k))
        wr = torch.empty((b, k, n), dtype=torch.float32, device=x.device)
        wi = torch.empty((b, k, n), dtype=torch.float32, device=x.device)
        _cuda.launch(
            "extract", "lq_extract_windows", x.device,
            x.data_ptr(), starts.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            b, t, k, n,
        )
    if return_planes:
        return wr, wi
    return torch.complex(wr, wi)
