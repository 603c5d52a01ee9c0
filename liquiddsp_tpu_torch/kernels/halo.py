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

``halo_windows_dist`` is the entry of a rank of a distributed mesh
(parallel/mesh.py): the rank's ``L`` local shards as above, its first
shard's head pushed by the same kernel into the left rank's last window
through a CUDA IPC mapping (parallel/peer.py), and its own last tail filled
by the right rank's push (zero at the end of the stream). Its plain version,
for a CPU mesh, is ``halo_windows_ref`` with the right rank's head received
by a send and a receive (``halo_windows_dist_ref``).
"""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.parallel import peer

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
    return halo_windows_dist_ref(x, n_time, ov, None)


def halo_windows_dist_ref(x: torch.Tensor, n_time: int, ov: int,
                          right_head: torch.Tensor | None) -> torch.Tensor:
    """Plain PyTorch version of a rank's windows: x [B, n_time*T_local] is
    the rank's block, ``right_head`` [B, ov] the first ``ov`` samples of the
    right rank's block (None: the end of the stream, zeros)."""
    t_local = _shard_len(x, n_time, ov)
    b = x.shape[0]
    xs = x.to(torch.complex64).reshape(b, n_time, t_local).transpose(0, 1)
    last = (torch.zeros((b, ov), dtype=torch.complex64, device=x.device)
            if right_head is None else right_head.to(torch.complex64))
    tails = torch.cat([xs[1:, :, :ov], last[None]], dim=0)  # shard s gets s+1's head
    return torch.cat([xs, tails], dim=-1).contiguous()


def _check_launch(x: torch.Tensor, n_time: int, ov: int) -> int:
    t_local = _shard_len(x, n_time, ov)
    _cuda.check_cuda("x", x, torch.complex64, tuple(x.shape))
    if -(-t_local // _CHUNK) > 65535:  # row chunks ride on gridDim.y
        raise ValueError(f"x: time shards of {t_local} samples are too long")
    return t_local


def halo_windows_into(x: torch.Tensor, n_time: int, ov: int, win: torch.Tensor,
                      left: torch.Tensor | None, zero_last: bool) -> torch.Tensor:
    """Launch the halo kernel: x [B, n_time*T_local] complex64 on the card
    -> ``win`` [n_time, B, T_local + ov]; shard 0's head goes into the tail
    of ``left``'s last window (the left rank's buffer of the same shape,
    mapped into this process; None: no rank to the left), and the last tail
    is zeroed when ``zero_last``, else left to the right rank's push."""
    t_local = _check_launch(x, n_time, ov)
    b = x.shape[0]
    _cuda.check_cuda("win", win, torch.complex64, (n_time, b, t_local + ov))
    if left is not None:
        _cuda.check_cuda("left", left, torch.complex64, tuple(win.shape))
    _cuda.launch(
        "halo", "lq_halo_windows", x.device,
        x.data_ptr(), win.data_ptr(), None if left is None else left.data_ptr(),
        b, n_time, t_local, ov, x.stride(0), int(zero_last),
    )
    return win


def halo_windows(x: torch.Tensor, n_time: int, ov: int) -> torch.Tensor:
    """x [B, n_time*T_local] complex64 -> windows [n_time, B, T_local + ov]
    complex64: ``windows[s, b, :T_local]`` is shard s of row b,
    ``windows[s, b, T_local:]`` the first ``ov`` samples of shard s + 1, or
    zeros for the last shard."""
    if not x.is_cuda:
        return halo_windows_ref(x, n_time, ov)
    t_local = _check_launch(x, n_time, ov)
    win = torch.empty((n_time, x.shape[0], t_local + ov), dtype=torch.complex64, device=x.device)
    # every shard lives on this card: no rank to the left
    return halo_windows_into(x, n_time, ov, win, None, True)


def halo_windows_dist(x_local: torch.Tensor, mesh, ov: int) -> torch.Tensor:
    """The windows [L, B_local, T_local + ov] of this rank's block ``x_local``
    [B_local, L*T_local] of a distributed mesh, its last tail the right
    rank's head. On a card the rank's buffer is one of the mesh's shared
    window buffers, valid until the step after next; the halo exchange is the
    kernel's push alone (no collective carries samples), followed by the
    step's barrier (parallel/peer.py). In one process, ``halo_windows``."""
    n = mesh.local_time
    if mesh.world == 1:
        return halo_windows(x_local, n, ov)
    if not x_local.is_cuda:
        return halo_windows_dist_ref(x_local, n, ov, peer.recv_right_head(x_local, mesh, ov))
    t_local = _check_launch(x_local, n, ov)
    pw = peer.peer_windows(mesh, (n, x_local.shape[0], t_local + ov))
    win, left = pw.next()
    halo_windows_into(x_local, n, ov, win, left, mesh.holds_last_time)
    pw.arrived()
    return win
