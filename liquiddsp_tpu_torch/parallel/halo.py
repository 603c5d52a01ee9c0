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

On one device the shards are rows of the batch: the local receiver runs once
on ``[n_time * B, T_local + ov]``, so a few long channels become many short
ones for the correlator, the top-K and every later stage. A mesh that spans
several devices is not ported yet (parallel/mesh.py refuses to build one).
"""

from __future__ import annotations

import dataclasses

import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.kernels.halo import halo_windows
from liquiddsp_tpu_torch.parallel.mesh import Mesh
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.framesync import FrameResults, framesync_fixed

HALO_MODES = ("auto", "dma", "copy")


def shard_stream(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Place a host or device [B, T] stream on the mesh: rows over ``ch``,
    time blocks over ``time`` (on one device, one contiguous tensor)."""
    return x.to(device=mesh.checked_device(), dtype=torch.complex64).contiguous()


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
    indices.

    ``halo`` is kept for the JAX package's signature. The windows are always
    built by ``kernels/halo.halo_windows``: the halo kernel for a stream on a
    GPU, its plain version for a stream on the CPU. "auto" and "dma" mean
    that; "copy" (the plain version, the stand-in for the JAX package's
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
    dev = mesh.checked_device()
    n_time = mesh.n_time
    ov = fs.FrameSpec(cfg).frame_samples - 1
    x = shard_stream(x, mesh)
    b, t = x.shape
    if b % mesh.n_ch:
        raise ValueError(f"{b} channels do not split over a ch axis of {mesh.n_ch}")
    windows = halo_windows(x, n_time, ov)  # [n_time, B, T_local + ov]
    t_local = t // n_time
    res = framesync_fixed(
        windows.reshape(n_time * b, t_local + ov), cfg,
        max_frames=max_frames_per_shard, threshold=threshold, device=dev,
    )
    tidx = torch.arange(n_time, device=dev, dtype=torch.int32).repeat_interleave(b)[:, None]
    own = res.start < t_local  # frames starting in my block are mine
    res = dataclasses.replace(
        res,
        mask=res.mask & own,
        header_valid=res.header_valid & own,
        payload_valid=res.payload_valid & own,
        start=res.start + tidx * t_local,
    )

    def by_channel(a):  # [n_time*B, K, ...] -> [B, n_time*K, ...]
        k = a.shape[1]
        a = a.reshape((n_time, b, k) + a.shape[2:]).transpose(0, 1)
        return a.reshape((b, n_time * k) + a.shape[3:])

    return dataclasses.replace(res, **{
        f.name: by_channel(getattr(res, f.name))
        for f in dataclasses.fields(res)
        if isinstance(getattr(res, f.name), torch.Tensor)
    })
