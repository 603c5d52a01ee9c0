"""Halo windows of a time-sharded stream.

A stream row of ``n_time * T_local`` samples is cut into ``n_time`` time
shards. A frame may start in one shard and end in the next, so shard ``s``
decodes from the window ``[its own T_local samples | the first ov samples of
shard s + 1]`` with ``ov = frame_samples - 1``; the tail of the last shard is
zero (end of the stream). Exact: it only moves data.

``halo_windows`` launches the CUDA kernel ``csrc/halo.cu`` for a CUDA tensor
(the counterpart of ``_window_with_halo_dma`` in
``liquiddsp_tpu/parallel/halo.py``: each shard's owner copies its block and
pushes its head into its left neighbour's window) and takes
``halo_windows_ref`` only for a CPU tensor. The windows carry exactly ``ov``
tail samples and exactly the rows given: no lane or sublane padding, and the
last tail is zero already.
"""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.kernels import _cuda

_CHUNK = 8192  # samples of a row per thread block: CHUNK in csrc/halo.cu

def _shard_len(x: torch.Tensor, n_time: int, ov: int) -> int:
    if x.dim() != 2:
        raise ValueError(f"x: expected [B, T], got shape {tuple(x.shape)}")
    t = x.shape[1]
    if n_time < 1 or t % n_time:
        raise ValueError(f"x: {t} samples do not split into {n_time} equal time shards")
    t_local = t // n_time
    if not 0 <= ov <= t_local:
        raise ValueError(f"overlap {ov} must lie in 0..{t_local}, the shard length")
    return t_local


def halo_windows_ref(x: torch.Tensor, n_time: int, ov: int) -> torch.Tensor:
    """Plain PyTorch version: x [B, n_time*T_local] complex64 ->
    windows [n_time, B, T_local + ov] complex64."""
    t_local = _shard_len(x, n_time, ov)
    b = x.shape[0]
    xs = x.to(torch.complex64).reshape(b, n_time, t_local).transpose(0, 1)
    zeros = torch.zeros((1, b, ov), dtype=torch.complex64, device=x.device)
    tails = torch.cat([xs[1:, :, :ov], zeros], dim=0)  # shard s gets s+1's head
    return torch.cat([xs, tails], dim=-1).contiguous()


def halo_windows(x: torch.Tensor, n_time: int, ov: int) -> torch.Tensor:
    """x [B, n_time*T_local] complex64 -> windows [n_time, B, T_local + ov]
    complex64: ``windows[s, b, :T_local]`` is shard s of row b,
    ``windows[s, b, T_local:]`` the first ``ov`` samples of shard s + 1, or
    zeros for the last shard."""
    if not x.is_cuda:
        return halo_windows_ref(x, n_time, ov)
    t_local = _shard_len(x, n_time, ov)
    b, t = x.shape
    _cuda.check_cuda("x", x, torch.complex64, (b, t))
    if -(-t_local // _CHUNK) > 65535:  # row chunks ride on gridDim.y
        raise ValueError(f"x: time shards of {t_local} samples are too long")
    win = torch.empty((n_time, b, t_local + ov), dtype=torch.complex64, device=x.device)
    # every shard lives on this card: the left neighbours' windows are in
    # ``win`` itself
    _cuda.launch(
        "halo", "lq_halo_windows", x.device,
        x.data_ptr(), win.data_ptr(), win.data_ptr(), b, n_time, t_local, ov, x.stride(0),
    )
    return win
