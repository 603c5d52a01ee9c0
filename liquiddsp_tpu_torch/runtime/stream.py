"""Chunked streaming RX with carry state across block boundaries.

Counterpart of ``liquiddsp_tpu/runtime/stream.py``. The reference streams
continuously: GR hands flex_rx 256-sample chunks and liquid's flexframesync
keeps internal history so a frame may straddle any chunk boundary
(lib/flex_rx_impl.h:47, cc:210-215).

Here the chunk is a large batched block and the carry is an explicit
overlap (overlap-save): each step decodes ``window = [carry | chunk]`` with
``len(carry) = frame_samples - 1`` and keeps only the frames *fully
contained* in the window (start <= W - F). A frame that starts in the last
F - 1 samples reappears at the head of the next window and is decoded
exactly once there.

The window is one ``[B, overlap + chunk_len]`` buffer on the device that
the object owns: a step writes the chunk into it, runs ``framesync_fixed``
and moves the tail to the front (an update in place). That buffer is the
carry of the instance's programs (``core.program``), keyed as the JAX
package keys its jits: on a card ``step`` replays one CUDA graph per slot
count ``k``, and ``superstep`` one graph per ``(k, N)`` that sweeps all N
windows (the JAX ``lax.scan``, unrolled at capture), so N chunks are one
replay; ``run_adaptive`` takes one such graph per bucket, with the group's
demand as one device scalar. The window base rides into a graph as a device
scalar written before each replay; the stream position, the epoch split and
the bound of a launch stay on the host. On the CPU the same bodies run
directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.core.program import Program
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.framesync import FrameResults, framesync_fixed
from liquiddsp_tpu_torch.phy.tables import phy_tables

# slot-count buckets for the occupancy-adaptive decode: geometric-ish so
# the overshoot over the demand stays about 25 % or less
K_BUCKETS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 40, 48, 64)

_EPOCH_BITS = 30


def _stack(results: list[FrameResults], epoch: int) -> FrameResults:
    """N per-chunk results -> one whose tensor fields are [N, B, K, ...]."""
    fields = {
        f.name: torch.stack([getattr(r, f.name) for r in results])
        for f in dataclasses.fields(FrameResults) if f.name != "epoch"
    }
    return FrameResults(**fields, epoch=epoch)


def split_results(stacked: FrameResults, n: int) -> list[FrameResults]:
    """Unstack a [N, B, K, ...] superstep result into N per-chunk results
    (views, no copy)."""
    return [
        FrameResults(**{
            f.name: getattr(stacked, f.name)[i]
            for f in dataclasses.fields(FrameResults) if f.name != "epoch"
        }, epoch=stacked.epoch)
        for i in range(n)
    ]


class StreamingRx:
    """Stateful streaming wrapper around the block framesync.

    One instance per continuous stream batch [B, *] on ``device`` (``None``:
    the GPU). ``chunk_len`` is fixed. Every per-candidate stage scales with
    the K slots; ``max_frames_per_chunk`` defaults to worst-case
    back-to-back frames, and a deployment that knows its frame rate passes
    the slots it needs (or uses :meth:`run_adaptive`).

    After :meth:`run_adaptive`, ``adaptive_buckets`` holds every slot count
    that decoded a launch group and ``adaptive_redos`` the number of groups
    decoded again at a larger bucket (both cumulative over the instance).
    """

    def __init__(
        self,
        cfg: FrameConfig,
        batch: int,
        chunk_len: int,
        max_frames_per_chunk: int | None = None,
        threshold: float = 0.45,
        *,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.chunk_len = chunk_len
        self.frame_samples = fs.FrameSpec(cfg).frame_samples
        self.overlap = self.frame_samples - 1
        if chunk_len <= self.overlap:
            raise ValueError(f"chunk_len {chunk_len} must exceed overlap {self.overlap}")
        self.max_frames = max_frames_per_chunk or max(
            2, (chunk_len + self.overlap) // self.frame_samples + 1
        )
        self.threshold = threshold
        self.tables = phy_tables(cfg, self.device)
        self._buf = torch.zeros(
            (batch, self.overlap + chunk_len), dtype=torch.complex64, device=self.device
        )
        self._samples_consumed = 0  # absolute index of carry[0] (python int)
        self.start_epoch = 0  # host-side 2^30 base of res.start (see _base)
        self._pending = None  # push() arrival buffer (host, [B, < chunk_len])
        self._adaptive_k = None  # settled bucket of run_adaptive
        self.adaptive_buckets: set[int] = set()
        self.adaptive_redos = 0
        # ("step", k) or ("superstep", k, N, with_count) -> a graph on a card
        self.program = Program("StreamingRx", self._body, state=(self._buf,))

    @property
    def _carry(self) -> torch.Tensor:
        """The overlap carry: a view of the head of the window buffer."""
        return self._buf[:, : self.overlap]

    @_carry.setter
    def _carry(self, value) -> None:
        self._buf[:, : self.overlap].copy_(torch.as_tensor(value))

    def reset(self) -> None:
        """Zero the carry and stream position (a new stream, same buffers).
        The settled bucket of :meth:`run_adaptive` persists."""
        self._buf.zero_()
        self._samples_consumed = 0
        self.start_epoch = 0
        self._pending = None

    def _base(self) -> int:
        """In-epoch window base; sets ``start_epoch``.

        ``start`` rides on the device as int32, which would wrap after 2^31
        stream samples (about 36 min of a 1 Msamp/s channel). The unbounded
        position is split into ``start_epoch`` (a multiple of 2^30, host side)
        plus a small in-epoch offset added on the device: absolute index =
        ``res.epoch + res.start``. Streams shorter than 2^30 samples always
        see epoch 0."""
        base_abs = self._samples_consumed - self.overlap
        self.start_epoch = (max(base_abs, 0) >> _EPOCH_BITS) << _EPOCH_BITS
        return base_abs - self.start_epoch

    def _window(self, chunk: torch.Tensor, k: int, base: torch.Tensor, with_count: bool):
        """One window, the body of every program: write ``chunk``, decode
        with ``k`` slots, keep the contained frames, offset ``start`` by the
        device scalar ``base``, move the carry."""
        ov = self.overlap
        self._buf[:, ov:].copy_(chunk)
        out = framesync_fixed(
            self._buf, self.cfg, k, self.threshold, return_peak_count=with_count,
            tables=self.tables, device=self.device,
        )
        res, count = out if with_count else (out, None)
        contained = res.start <= self._buf.shape[-1] - self.frame_samples
        res = dataclasses.replace(
            res,
            mask=res.mask & contained,
            header_valid=res.header_valid & contained,
            payload_valid=res.payload_valid & contained,
            # start as a stream sample index within the epoch (int32: a
            # 0-dim int64 does not promote it)
            start=res.start + base,
        )
        self._buf[:, :ov] = self._buf[:, self.chunk_len :].clone()
        return res, count

    def _body(self, key: tuple):
        """The program of ``key``: ("step", k) takes a [B, L] chunk and the
        window base; ("superstep", k, N, with_count) [B, N, L] chunks and the
        base of the first, and returns the stacked [N, B, K, ...] results
        (and the group's demand: the largest threshold-peak count of its
        windows, one device scalar)."""
        if key[0] == "step":
            k = key[1]
            return lambda chunk, base: self._window(chunk, k, base, False)[0]
        _, k, n, with_count = key

        def sweep(chunks, base):
            results, counts = [], []
            for i in range(n):
                res, count = self._window(chunks[:, i], k, base + i * self.chunk_len, with_count)
                results.append(res)
                counts.append(count)
            stacked = _stack(results, 0)
            return (stacked, torch.stack(counts).max()) if with_count else stacked

        return sweep

    def _as_chunk(self, chunk) -> torch.Tensor:
        if not isinstance(chunk, torch.Tensor):
            chunk = torch.as_tensor(chunk)
        if tuple(chunk.shape) != (self.batch, self.chunk_len):
            raise ValueError(
                f"chunk: expected shape {(self.batch, self.chunk_len)}, got {tuple(chunk.shape)}")
        return chunk

    def step(self, chunk) -> FrameResults:
        """Process [B, chunk_len] new samples (numpy or torch); returns
        FrameResults whose ``start`` fields are stream sample indices
        relative to ``res.epoch``."""
        chunk = self._as_chunk(chunk)
        res = self.program(("step", self.max_frames), chunk, self._base(), device=self.device)
        self._samples_consumed += self.chunk_len
        return dataclasses.replace(res, epoch=self.start_epoch)

    def push(self, samples) -> list[FrameResults]:
        """GR-style arbitrary chunking (the reference feeds flexframesync
        256-sample chunks, lib/flex_rx_impl.cc:213): accept [B, n] for ANY
        n >= 1 (numpy or torch), buffer on the host, and step whenever a full
        ``chunk_len`` has accumulated. Returns the FrameResults of every step
        this push completed (possibly none); each carries its own epoch.
        Use :meth:`flush` at the end of the stream."""
        if isinstance(samples, torch.Tensor):
            samples = samples.detach().cpu().numpy()
        samples = np.asarray(samples)
        if samples.ndim != 2 or samples.shape[0] != self.batch:
            raise ValueError(f"push: expected [{self.batch}, n], got {samples.shape}")
        if self._pending is None:
            self._pending = np.zeros((self.batch, 0), dtype=np.complex64)
        self._pending = np.concatenate([self._pending, samples.astype(np.complex64)], axis=1)
        out: list[FrameResults] = []
        while self._pending.shape[1] >= self.chunk_len:
            chunk = self._pending[:, : self.chunk_len]
            self._pending = self._pending[:, self.chunk_len :]
            out.append(self.step(chunk))
        return out

    def flush(self) -> FrameResults | None:
        """End of stream: zero-pad the pending tail to one chunk and step.
        None when nothing is pending. Frames that would run past the true end
        of the data decode against zeros (as in :meth:`run`)."""
        if self._pending is None or self._pending.shape[1] == 0:
            return None
        chunk = np.pad(self._pending, ((0, 0), (0, self.chunk_len - self._pending.shape[1])))
        self._pending = np.zeros((self.batch, 0), dtype=np.complex64)
        return self.step(chunk)

    def _chunks_of(self, chunks) -> torch.Tensor:
        """[B, N, L] or [B, N*L] (numpy or torch) -> [B, N, L] tensor."""
        if not isinstance(chunks, torch.Tensor):
            chunks = torch.as_tensor(chunks)
        if chunks.dim() == 2:
            b, t = chunks.shape
            if t % self.chunk_len:
                raise ValueError(f"{t} samples are no whole number of {self.chunk_len}-sample chunks")
            chunks = chunks.reshape(b, t // self.chunk_len, self.chunk_len)
        if chunks.shape[0] != self.batch or chunks.shape[2] != self.chunk_len:
            raise ValueError(f"chunks: expected [{self.batch}, N, {self.chunk_len}], got {tuple(chunks.shape)}")
        return chunks

    def _launch(self, chunks: torch.Tensor, k: int, with_count: bool = False):
        """N chunks under ONE epoch base, one program call: (stacked
        FrameResults, the group's demand as a device scalar, or None)."""
        n = chunks.shape[1]
        # the base can sit up to 2^30 into the current epoch; bound the
        # largest in-launch index below int32's maximum
        assert n * self.chunk_len + self.frame_samples < (1 << _EPOCH_BITS), (
            "launch exceeds one start epoch")
        base0 = self._base()
        out = self.program(("superstep", k, n, with_count), chunks, base0, device=self.device)
        self._samples_consumed += n * self.chunk_len
        res, demand = out if with_count else (out, None)
        return dataclasses.replace(res, epoch=self.start_epoch), demand

    def superstep(self, chunks) -> FrameResults:
        """Process N chunks in one call: ``[B, N, chunk_len]`` or
        ``[B, N*chunk_len]``. Returns FrameResults whose fields are stacked
        ``[N, B, K, ...]``; one epoch covers the whole call (absolute index =
        ``res.epoch + start``). Equal to N calls of :meth:`step`, the
        exactly-once straddle contract included."""
        return self._launch(self._chunks_of(chunks), self.max_frames)[0]

    def _padded(self, stream) -> torch.Tensor:
        """[B, T] (numpy or torch) -> [B, ceil(T / L) * L] on the device, the
        tail zero-padded: one copy up front, so launch groups queue on the
        device without waiting on the host."""
        stream = torch.as_tensor(stream).to(self.device)
        pad = (-stream.shape[1]) % self.chunk_len
        if pad:
            stream = torch.nn.functional.pad(stream, (0, pad))
        return stream.reshape(stream.shape[0], -1, self.chunk_len)

    def run(self, stream, chunks_per_launch: int = 1) -> list[FrameResults]:
        """Chop [B, T] into chunks (zero-padding the tail) and decode them:
        a list of per-chunk FrameResults. ``chunks_per_launch > 1`` routes
        groups of chunks through :meth:`superstep`."""
        chunks = self._padded(stream)
        n = chunks.shape[1]
        if chunks_per_launch <= 1:
            return [self.step(chunks[:, i]) for i in range(n)]
        out: list[FrameResults] = []
        n_full = (n // chunks_per_launch) * chunks_per_launch
        for g in range(0, n_full, chunks_per_launch):
            out.extend(split_results(self.superstep(chunks[:, g : g + chunks_per_launch]),
                                     chunks_per_launch))
        out.extend(self.step(chunks[:, i]) for i in range(n_full, n))
        return out

    def run_adaptive(
        self,
        stream,
        chunks_per_launch: int = 5,
        k_buckets: tuple[int, ...] = K_BUCKETS,
        headroom: int = 2,
        split: bool = True,
    ) -> list[FrameResults]:
        """Occupancy-adaptive :meth:`run`: the slot count K follows the
        MEASURED detector demand instead of worst-case provisioning.

        1. Every launch group (``chunks_per_launch`` chunks) is queued at the
           current bucket; its demand, the largest threshold-peak count of its
           windows (the demand before the top-K cut), stays a device scalar.
        2. All demands come to the host in ONE copy.
        3. Each group whose demand exceeded its bucket is decoded again at a
           bucket that covers demand + ``headroom``, from a clone of the carry
           and stream position saved before it. The settled bucket persists
           on the instance for the next call.

        Exactly-once is unaffected: the carry is raw data, independent of K,
        so a second decode reproduces the same carry chain. ``split=False``
        returns one stacked FrameResults ([N, B, K, ...]) per group. The tail
        that fills no whole group runs through :meth:`step`.
        """
        chunks = self._padded(stream)
        n = chunks.shape[1]
        buckets = sorted({k for k in k_buckets if k < self.max_frames})
        # the demand can exceed max_frames (threshold chatter), but max_frames
        # is the provisioning run() would use: never decode worse
        buckets.append(self.max_frames)

        def pick(demand: int) -> int:
            return next((b for b in buckets if b >= demand + headroom), buckets[-1])

        n_full = (n // chunks_per_launch) * chunks_per_launch
        k = self._adaptive_k if self._adaptive_k in buckets else buckets[0]

        groups = []  # [first chunk, state before, result, demand on the device]
        for g in range(0, n_full, chunks_per_launch):
            before = (self._carry.clone(), self._samples_consumed)
            res, demand = self._launch(chunks[:, g : g + chunks_per_launch], k, with_count=True)
            self.adaptive_buckets.add(k)
            groups.append([g, before, res, demand])

        if groups:
            demands = torch.stack([e[3] for e in groups]).cpu().numpy().astype(np.int64)
            for entry, demand in zip(groups, demands):
                if demand > k:
                    k_fix = pick(int(demand))
                    live = (self._carry.clone(), self._samples_consumed, self.start_epoch)
                    self._carry, self._samples_consumed = entry[1]
                    g = entry[0]
                    entry[2] = self._launch(chunks[:, g : g + chunks_per_launch], k_fix,
                                            with_count=True)[0]
                    self.adaptive_buckets.add(k_fix)
                    self.adaptive_redos += 1
                    self._carry, self._samples_consumed, self.start_epoch = live
            self._adaptive_k = pick(int(demands.max()))

        out: list[FrameResults] = []
        for _, _, res, _ in groups:
            out.extend(split_results(res, chunks_per_launch) if split else [res])
        out.extend(self.step(chunks[:, i]) for i in range(n_full, n))
        return out
