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
the carry and the chunk into it and runs the sharded receiver (an update in
place: the window is this object's own buffer). Over the ranks of a
distributed mesh every rank is handed the same chunk, as each JAX controller
builds the same stream, and copies only its own block of the window onto its
device; the carry is the stream's last ``ov`` samples, which every rank takes
from the chunk, so it needs no transfer between processes. The metrics are
summed over the ranks (``LinkMetrics.psum``): every rank returns the global
ones, and its own slots.
"""

from __future__ import annotations

import dataclasses

import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.parallel.halo import decode_block
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
        # this rank's part of the window: its ch group's rows, the columns
        # of its time shards (everything in one process)
        if batch % mesh.n_ch:
            raise ValueError(f"{batch} channels do not split over a ch axis of {mesh.n_ch}")
        self.rows = mesh.ch_rows(batch)
        t_local = self.window // self.n_time
        shards = mesh.time_shards
        self.cols = (shards.start * t_local, shards.stop * t_local)
        self._buf = torch.zeros(
            (self.rows.stop - self.rows.start, self.cols[1] - self.cols[0]),
            dtype=torch.complex64, device=self.device,
        )
        self._carry = torch.zeros((self._buf.shape[0], self.overlap),
                                  dtype=torch.complex64, device=self.device)
        self._consumed = 0
        self.start_epoch = 0  # host-side 2^30 base of res.start (int32-wrap guard)

    def reset(self) -> None:
        """Zero the carry and stream position (new stream, same buffers)."""
        self._buf.zero_()
        self._carry.zero_()
        self._consumed = 0
        self.start_epoch = 0

    def step(self, chunk: torch.Tensor) -> tuple[FrameResults, LinkMetrics]:
        """[batch, chunk_len] new samples -> (FrameResults, LinkMetrics).

        Returned ``start`` values are stream sample indices relative to the
        result's ``epoch`` (zero for streams under 2^30 samples; an int32
        on the device would otherwise wrap on long-lived streams). Over
        ranks the results are this rank's slots, [B_local, L * K], and the
        metrics those of the whole mesh."""
        if tuple(chunk.shape) != (self.batch, self.chunk_len):
            raise ValueError(
                f"chunk: expected shape {(self.batch, self.chunk_len)}, got {tuple(chunk.shape)}"
            )
        ov, (lo, hi) = self.overlap, self.cols
        chunk = chunk[self.rows]
        # my columns of [carry | chunk | pad]: the pad stays zero
        if lo < ov:
            self._buf[:, : ov - lo] = self._carry[:, lo:]
        c0, c1 = max(lo, ov), min(hi, self.real_len)
        if c1 > c0:
            self._buf[:, c0 - lo : c1 - lo] = chunk[:, c0 - ov : c1 - ov].to(self.device)
        # next carry: the last ``overlap`` received samples
        if self.chunk_len >= ov:
            self._carry.copy_(chunk[:, self.chunk_len - ov :])
        else:
            self._carry.copy_(torch.cat([self._carry[:, self.chunk_len :], chunk.to(self.device)], dim=1))
        base_abs = self._consumed - ov
        self.start_epoch = (max(base_abs, 0) >> 30) << 30
        res = decode_block(self._buf, self.cfg, self.mesh, self.max_frames, self.threshold)
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
        # the window's samples, counted once: by the ranks of ch group 0
        samples = hi - lo if self.mesh.coords[1] == 0 else 0
        metrics = LinkMetrics.from_results(res, samples).psum(self.mesh)
        self._consumed += self.chunk_len
        return res, metrics
