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
by the right rank's push (zero at the end of the stream). On a card it is
one step of ``parallel/peer.py``'s order: ``halo_order`` (the kernel's
receive-semaphore wait, a launch counted as ``halo_wait``) before and after
the halo kernel, which sets the left rank's flag once its push has landed.
Its plain version, for a CPU mesh, is ``halo_windows_ref`` with the right
rank's head received by a send and a receive (``halo_windows_dist_ref``).
"""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.parallel import peer

_CHUNK = 2048  # samples of a row per thread block: CHUNK in csrc/halo.cu

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
                      left: torch.Tensor | None, zero_last: bool,
                      signal: torch.Tensor | None = None, value: int = 0,
                      count: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the halo kernel: x [B, n_time*T_local] complex64 on the card
    -> ``win`` [n_time, B, T_local + ov]; shard 0's head goes into the tail
    of ``left``'s last window (the left rank's buffer of the same shape,
    mapped into this process; None: no rank to the left), and the last tail
    is zeroed when ``zero_last``, else left to the right rank's push. With
    ``signal`` (a one-element int64 flag, here or mapped from a peer), the
    kernel stores ``value`` there once all its writes are visible; ``count``
    is a one-element int64 word on this card that is 0 between launches."""
    t_local = _check_launch(x, n_time, ov)
    b = x.shape[0]
    _cuda.check_cuda("win", win, torch.complex64, (n_time, b, t_local + ov))
    if left is not None:
        _cuda.check_cuda("left", left, torch.complex64, tuple(win.shape))
    args = (x.data_ptr(), win.data_ptr(), None if left is None else left.data_ptr(),
            b, n_time, t_local, ov, x.stride(0), int(zero_last))
    if signal is None:
        _cuda.launch("halo", "lq_halo_windows", x.device, *args)
    else:
        _check_flag("signal", signal)
        _check_flag("count", count)
        _cuda.launch("halo", "lq_halo_windows_signal", x.device, *args,
                     signal.data_ptr(), value, count.data_ptr())
    return win


def _check_flag(name: str, f: torch.Tensor | None) -> None:
    if f is None:
        raise ValueError(f"{name}: a flag is needed")
    _cuda.check_cuda(name, f, torch.int64, ())


def halo_order_ref(signal: torch.Tensor | None, signal_value: int,
                   wait: torch.Tensor | None, wait_value: int) -> None:
    """Plain version of ``halo_order``: the store, then the wait, which in
    one thread either holds already or never will (raises)."""
    if signal is not None:
        signal.fill_(signal_value)
    if wait is not None and int(wait) < wait_value:
        raise RuntimeError(f"waiting for {wait_value} in a flag that holds {int(wait)}, "
                           f"and nothing else writes it")


def halo_order(signal: torch.Tensor | None, signal_value: int,
               wait: torch.Tensor | None, wait_value: int) -> None:
    """Store ``signal_value`` into the flag ``signal``, then hold the
    stream until the flag ``wait`` reaches ``wait_value`` (either None:
    skipped). Flags are one-element int64 tensors, on this card or mapped
    from a peer's; every store to them only raises them. On the card one
    launch of ``csrc/halo.cu``'s wait kernel on the current stream, which
    returns at once to the host; ``halo_order_ref`` for CPU tensors."""
    flags = [f for f in (signal, wait) if f is not None]
    if not flags:
        raise ValueError("halo_order: neither a flag to store nor one to wait on")
    if not flags[0].is_cuda:
        return halo_order_ref(signal, signal_value, wait, wait_value)
    for name, f in (("signal", signal), ("wait", wait)):
        if f is not None:
            _check_flag(name, f)
    _cuda.launch("halo_wait", "lq_halo_order", flags[0].device,
                 None if signal is None else signal.data_ptr(), signal_value,
                 None if wait is None else wait.data_ptr(), wait_value)


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
    kernel's push alone (no collective carries samples), ordered by flags on
    the card (parallel/peer.py): one step, enqueued on the current stream
    without waiting on the host. Where no rank shares my time column (one
    process, or ranks across channels only), ``halo_windows``."""
    n = mesh.local_time
    if mesh.ranks[0] == 1:
        return halo_windows(x_local, n, ov)
    if not x_local.is_cuda:
        return halo_windows_dist_ref(x_local, n, ov, peer.recv_right_head(x_local, mesh, ov))
    t_local = _check_launch(x_local, n, ov)
    pw = peer.peer_windows(mesh, (n, x_local.shape[0], t_local + ov))
    st = pw.next()
    i = st.buf
    mine, theirs = pw.flags, pw.left_flags
    # 1-2: release my buffer's use of two steps ago; wait until the left
    # rank has released its buffer i
    halo_order(None if st.release is None else mine[peer.FREE + i], st.release or 0,
               None if st.wait_free is None else theirs[peer.FREE + i], st.wait_free or 0)
    # 3-4: the local copy and the push, then the left rank's arrived[i]
    left = None if pw.left is None else pw.left[i]
    signal = None if st.arrive is None else theirs[peer.ARRIVED + i]
    halo_windows_into(x_local, n, ov, pw.own[i], left, mesh.holds_last_time,
                      signal, st.arrive or 0, mine[peer.COUNT])
    # 5: the right rank's push into my buffer i has landed
    if st.wait_arrived is not None:
        halo_order(None, 0, mine[peer.ARRIVED + i], st.wait_arrived)
    return pw.own[i]
