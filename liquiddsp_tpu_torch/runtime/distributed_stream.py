"""Continuous time-sharded streaming RX: time-block sharding + super-block
carry.

Counterpart of ``liquiddsp_tpu/runtime/distributed_stream.py``. Two nested
carry mechanisms:

- *within* a super-block: each time shard completes boundary-straddling
  frames with one halo from its right neighbour
  (parallel/halo.sharded_framesync);
- *between* super-blocks: the stream's global tail (the last
  frame_samples - 1 samples) is put before the next super-block, so a frame
  straddling the super-block edge is decoded once, in the block where it
  starts.

The window ``[carry | chunk | zero pad]`` is allocated once; a step writes
the chunk into it, runs the sharded receiver and moves the tail to the front
(an update in place: the window is this object's own buffer).
"""

from __future__ import annotations

import dataclasses

import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.parallel.halo import sharded_framesync
from liquiddsp_tpu_torch.parallel.mesh import Mesh
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.framesync import FrameResults
from liquiddsp_tpu_torch.utils.metrics import LinkMetrics


class ShardedStreamingRx:
    """Streaming wrapper over an n_time x n_ch mesh.

    ``chunk_len`` is the per-super-block length; each step consumes
    [batch, chunk_len] new samples.
    """

    def __init__(
        self,
        cfg: FrameConfig,
        mesh: Mesh,
        batch: int,
        chunk_len: int,
        max_frames_per_shard: int = 8,
        threshold: float = 0.45,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.batch = batch
        self.n_time = mesh.n_time
        self.device = mesh.checked_device()
        self.frame_samples = fs.FrameSpec(cfg).frame_samples
        self.overlap = self.frame_samples - 1
        # window length = overlap + chunk, padded so each shard gets an equal
        # time block
        self.real_len = self.overlap + chunk_len
        self.pad = (-self.real_len) % self.n_time
        self.window = self.real_len + self.pad
        if self.window // self.n_time <= self.overlap:
            raise ValueError("chunk too small for the mesh: shard < overlap")
        self.chunk_len = chunk_len
        self.max_frames = max_frames_per_shard
        self.threshold = threshold
        self._buf = torch.zeros(
            (batch, self.window), dtype=torch.complex64, device=self.device
        )
        self._consumed = 0
        self.start_epoch = 0  # host-side 2^30 base of res.start (int32-wrap guard)

    def reset(self) -> None:
        """Zero the carry and stream position (new stream, same buffers)."""
        self._buf.zero_()
        self._consumed = 0
        self.start_epoch = 0

    def step(self, chunk: torch.Tensor) -> tuple[FrameResults, LinkMetrics]:
        """[batch, chunk_len] new samples -> (FrameResults, LinkMetrics).

        Returned ``start`` values are stream sample indices relative to the
        result's ``epoch`` (zero for streams under 2^30 samples; an int32
        on the device would otherwise wrap on long-lived streams)."""
        if tuple(chunk.shape) != (self.batch, self.chunk_len):
            raise ValueError(
                f"chunk: expected shape {(self.batch, self.chunk_len)}, got {tuple(chunk.shape)}"
            )
        ov = self.overlap
        self._buf[:, ov : self.real_len] = chunk.to(self.device)
        base_abs = self._consumed - ov
        self.start_epoch = (max(base_abs, 0) >> 30) << 30
        res = sharded_framesync(
            self._buf, self.cfg, self.mesh,
            max_frames_per_shard=self.max_frames, threshold=self.threshold,
        )
        # mask frames not fully contained in the *received* samples (the zero
        # pad is not future data); they re-appear at the head of the next
        # super-block via the carry
        contained = res.start <= self.real_len - self.frame_samples
        res = dataclasses.replace(
            res,
            mask=res.mask & contained,
            header_valid=res.header_valid & contained,
            payload_valid=res.payload_valid & contained,
            # start as a stream sample index, relative to this step's epoch
            start=res.start + (base_abs - self.start_epoch),
            epoch=self.start_epoch,
        )
        metrics = LinkMetrics.from_results(res, self.window)
        # next carry: the last ``overlap`` received samples
        self._buf[:, :ov] = self._buf[:, self.chunk_len : self.real_len].clone()
        self._consumed += self.chunk_len
        return res, metrics
