"""Observability: per-block link metrics and a profiler hook.

Counterpart of ``liquiddsp_tpu/utils/metrics.py``:

- ``LinkMetrics``: per-block counters (frames detected / header ok / payload
  ok, EVM, RSSI) as 0-d tensors on the results' device: one scalar bundle per
  block, no per-frame host traffic. On one device the sum over the
  [B, n_time*K] slots of a sharded result is already the sum over the mesh;
  over the ranks of a distributed mesh ``psum`` sums each rank's metrics
  with one ``all_reduce``.
- ``MetricsCollector``: host-side accumulator with per-config receive
  counters and rate reporting.
- ``profile_trace``: context manager around ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from liquiddsp_tpu_torch.core.config import (
    NUM_INNER_CODES,
    NUM_MODULATIONS,
    NUM_OUTER_CODES,
)


@dataclasses.dataclass
class LinkMetrics:
    """Device-side per-block counters."""

    samples: torch.Tensor  # scalar int32
    frames_detected: torch.Tensor  # scalar int32
    headers_valid: torch.Tensor  # scalar int32
    payloads_valid: torch.Tensor  # scalar int32
    sum_evm_db: torch.Tensor  # scalar float32, over header-valid frames
    sum_rssi_db: torch.Tensor  # scalar float32

    @staticmethod
    def from_results(res, samples: int) -> "LinkMetrics":
        hv = res.header_valid
        count = lambda m: torch.sum(m, dtype=torch.int32)
        zero = torch.zeros((), dtype=torch.float32, device=hv.device)
        return LinkMetrics(
            samples=torch.tensor(samples, dtype=torch.int32, device=hv.device),
            frames_detected=count(res.mask),
            headers_valid=count(hv),
            payloads_valid=count(res.payload_valid),
            sum_evm_db=torch.sum(torch.where(hv, res.evm, zero)),
            sum_rssi_db=torch.sum(torch.where(hv, res.rssi, zero)),
        )

    def psum(self, mesh) -> "LinkMetrics":
        """The metrics summed over the ranks of ``mesh``, on this rank's
        device: one ``all_reduce`` of the six values packed as float64, which
        holds the int32 counts exactly. On gloo the pack goes through the
        host. A one-process mesh returns the metrics unchanged."""
        if mesh.world == 1:
            return self
        names = [f.name for f in dataclasses.fields(self)]
        dev = self.samples.device
        on_card = dist.get_backend(mesh.group) == "nccl"
        pack = torch.stack([getattr(self, n).to(torch.float64) for n in names])
        pack = pack if on_card else pack.cpu()
        dist.all_reduce(pack, group=mesh.group)
        pack = pack.to(dev)
        return LinkMetrics(**{
            n: pack[i].to(getattr(self, n).dtype) for i, n in enumerate(names)})


class MetricsCollector:
    """Host-side accumulator + per-config receive counters."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.samples = 0
        self.frames_detected = 0
        self.headers_valid = 0
        self.payloads_valid = 0
        self.sum_evm_db = 0.0
        shape = (NUM_MODULATIONS, NUM_INNER_CODES, NUM_OUTER_CODES)
        self.num_received = np.zeros(shape, dtype=np.int64)
        self.num_correct = np.zeros(shape, dtype=np.int64)

    def update(self, m: LinkMetrics):
        self.samples += int(m.samples)
        self.frames_detected += int(m.frames_detected)
        self.headers_valid += int(m.headers_valid)
        self.payloads_valid += int(m.payloads_valid)
        self.sum_evm_db += float(m.sum_evm_db)

    def count_packet(self, modulation: int, inner: int, outer: int, payload_valid: bool):
        self.num_received[modulation, inner, outer] += 1
        if payload_valid:
            self.num_correct[modulation, inner, outer] += 1

    def report(self) -> dict:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "samples": self.samples,
            "samples_per_sec": self.samples / dt,
            "frames_detected": self.frames_detected,
            "headers_valid": self.headers_valid,
            "payloads_valid": self.payloads_valid,
            "frame_success_rate": (
                self.payloads_valid / self.frames_detected if self.frames_detected else 0.0
            ),
            "mean_evm_db": (
                self.sum_evm_db / self.headers_valid if self.headers_valid else 0.0
            ),
            "elapsed_s": dt,
        }


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """``torch.profiler`` trace scope (no-op when logdir is None): host and,
    where there is a GPU, device activity, written on exit as a Chrome trace
    to ``logdir/trace.json``. Yields the profiler."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
