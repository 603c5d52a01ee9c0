"""The (time, ch) mesh of the sharded receiver.

Counterpart of ``liquiddsp_tpu/parallel/mesh.py``. The two axes are:

- ``ch``   (channel / data parallel): independent channels, no communication;
- ``time`` (sequence parallel): one contiguous sample stream cut into time
  blocks, neighbours exchanging a halo of boundary samples
  (parallel/halo.py).

A mesh is a small record: the two extents and the one ``torch.device`` that
holds every (time, ch) cell. On one card ``n_time`` time shards are ``n_time``
logical shards, rows of one batch. A mesh over several cards (a device per
cell, the push into a peer card's window, the all_reduce of the metrics) is
ROADMAP.md item A.4 and is refused here.
"""

from __future__ import annotations

import dataclasses

import torch

TIME_AXIS = "time"
CH_AXIS = "ch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_time: int
    n_ch: int
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {TIME_AXIS: self.n_time, CH_AXIS: self.n_ch}

    def checked_device(self) -> torch.device:
        """The mesh's device; raises for a GPU mesh on a machine without a
        GPU instead of letting the caller run on the CPU."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the mesh names a GPU; the tests build theirs with "
                'devices=["cpu"]'
            )
        return self.device


def make_mesh(n_time: int = 1, n_ch: int = 1, devices: list | None = None) -> Mesh:
    """Build a (time, ch) mesh of ``n_time * n_ch`` logical cells on one
    device.

    ``devices=None`` means the visible CUDA cards (raises without one); the
    tests pass ``devices=["cpu"]``. More than one distinct device raises
    ``NotImplementedError``: pass ``devices=[one of them]``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: make_mesh builds its mesh on the GPUs unless "
                'the caller passes devices (the tests pass ["cpu"])'
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = {torch.device(d) for d in devices}
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    if len(devs) != 1:
        raise NotImplementedError(
            f"a mesh over {len(devs)} devices is not ported yet: the push into a "
            "peer card's window and the all_reduce of the metrics are ROADMAP.md "
            "item A.4; put every cell on one device"
        )
    if n_time < 1 or n_ch < 1:
        raise ValueError(f"mesh extents must be positive, got ({n_time}, {n_ch})")
    return Mesh(n_time=n_time, n_ch=n_ch, device=devs.pop())
