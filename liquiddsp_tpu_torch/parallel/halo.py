"""Time-block-sharded RX with a halo exchange between neighbouring shards.

Counterpart of ``liquiddsp_tpu/parallel/halo.py``. A contiguous sample stream
is split into time blocks over the mesh ``time`` axis. A frame may straddle a
block boundary:

- every shard sends the first ``frame_samples - 1`` samples of its block to
  its LEFT neighbour (kernels/halo.py);
- each shard decodes frames *starting* inside its own block, using the halo
  to complete frames that extend into the right neighbour;
- the last shard's right halo is zero (end of stream) or, in continuous
  operation, the head of the next super-block
  (runtime/distributed_stream.py).

Ownership (start < T_local) guarantees that each frame is decoded exactly
once.

In one process the shards are rows of the batch: the local receiver runs
once on ``[n_time * B, T_local + ov]``, so a few long channels become many
short ones for the correlator, the top-K and every later stage. Over the
ranks of a distributed mesh (parallel/mesh.py) each rank does the same with
its own ``L`` shards of its ch group's rows, ``[L * B_local, T_local + ov]``,
the halo crossing to the left rank by the kernel's push
(``halo_windows_dist``). Each rank keeps its own slots; ``gather_results``
puts every rank's slots together in the one-process layout, for a check.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.kernels.halo import halo_windows_dist
from liquiddsp_tpu_torch.parallel.mesh import Mesh, local_block
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.framesync import FrameResults, framesync_fixed

HALO_MODES = ("auto", "dma", "copy")


def shard_stream(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Place a host or device [B, T] stream on the mesh: rows over ``ch``,
    time blocks over ``time``. In one process one contiguous tensor on the
    device; over ranks, this rank's block (``local_block``)."""
    return local_block(x, mesh)


def sharded_framesync(
    x: torch.Tensor,
    cfg: FrameConfig,
    mesh: Mesh,
    max_frames_per_shard: int = 8,
    threshold: float = 0.45,
    halo: str = "auto",
) -> FrameResults:
    """RX over a [B, T] stream cut into ``mesh.n_time`` time shards.

    Returns FrameResults with [B, n_time * K] slots, shard i's K slots at
    columns i*K .. (i+1)*K - 1; ``start`` entries are absolute stream
    indices. Over the ranks of a distributed mesh every rank is handed the
    same global stream, decodes its own block and returns its own slots,
    [B_local, L * K] (``gather_results`` assembles the global layout).

    ``halo`` is kept for the JAX package's signature. The windows are always
    built by ``kernels/halo``: the halo kernel for a stream on a GPU, its
    plain version for a stream on the CPU. "auto" and "dma" mean that;
    "copy" (the plain version, the stand-in for the JAX package's
    "ppermute") is taken for a CPU mesh only, where it is the same thing, and
    refused for a GPU mesh: the receiver does not run on a card without its
    kernel.
    """
    if halo not in HALO_MODES:
        raise ValueError(f"halo must be one of {HALO_MODES}, got {halo!r}")
    if halo == "copy" and mesh.device.type == "cuda":
        raise ValueError(
            'halo="copy" builds the windows without the halo kernel and is '
            "taken for a CPU mesh only"
        )
    if x.shape[0] % mesh.n_ch:
        raise ValueError(f"{x.shape[0]} channels do not split over a ch axis of {mesh.n_ch}")
    return decode_block(shard_stream(x, mesh), cfg, mesh, max_frames_per_shard, threshold)


def decode_block(x_local: torch.Tensor, cfg: FrameConfig, mesh: Mesh, max_frames: int,
                 threshold: float) -> FrameResults:
    """This rank's block [B_local, L * T_local] of the stream, on its device
    (in one process the whole stream) -> its slots [B_local, L * K]: the
    halo windows of its L shards, decoded in one framesync_fixed call, each
    shard's own frames kept, the slots laid out by channel, absolute
    starts."""
    dev = mesh.checked_device()
    ov = fs.FrameSpec(cfg).frame_samples - 1
    windows = halo_windows_dist(x_local, mesh, ov)  # [L, B_local, T_local + ov]
    n, b, w = windows.shape
    t_local = w - ov
    res = framesync_fixed(
        windows.reshape(n * b, w), cfg, max_frames=max_frames, threshold=threshold, device=dev,
    )
    first = mesh.time_shards.start
    tidx = torch.arange(first, first + n, device=dev, dtype=torch.int32).repeat_interleave(b)[:, None]
    own = res.start < t_local  # frames starting in my block are mine
    res = dataclasses.replace(
        res,
        mask=res.mask & own,
        header_valid=res.header_valid & own,
        payload_valid=res.payload_valid & own,
        start=res.start + tidx * t_local,
    )

    def by_channel(a):  # [n*B, K, ...] -> [B, n*K, ...]
        k = a.shape[1]
        a = a.reshape((n, b, k) + a.shape[2:]).transpose(0, 1)
        return a.reshape((b, n * k) + a.shape[3:])

    return dataclasses.replace(res, **{
        f.name: by_channel(getattr(res, f.name))
        for f in dataclasses.fields(res)
        if isinstance(getattr(res, f.name), torch.Tensor)
    })


def gather_results(res: FrameResults, mesh: Mesh) -> FrameResults:
    """Every rank's slots [B_local, L * K] in the one-process layout
    [B, n_time * K] on the host, on every rank (one all_gather of the
    host copies). In one process, the results on the host. For checks: the
    receiver itself never gathers."""
    host = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}
    host = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in host.items()}
    if mesh.world == 1:
        return FrameResults(**host)
    parts = [None] * mesh.world
    dist.all_gather_object(parts, host, group=mesh.group)
    p_t, p_c = mesh.ranks

    def place(name):
        # rank pt * P_c + pc holds rows of ch group pc, shards of time block pt
        rows = [torch.cat([parts[pt * p_c + pc][name] for pt in range(p_t)], dim=1)
                for pc in range(p_c)]
        return torch.cat(rows, dim=0)

    return FrameResults(**{
        k: place(k) if isinstance(v, torch.Tensor) else v for k, v in host.items()})
