"""The (time, ch) mesh of the sharded receiver, in one process or over ranks.

Counterpart of ``liquiddsp_tpu/parallel/mesh.py``. The two axes are:

- ``ch``   (channel / data parallel): independent channels, no communication;
- ``time`` (sequence parallel): one contiguous sample stream cut into time
  blocks, neighbours exchanging a halo of boundary samples
  (parallel/halo.py).

A mesh is a small record: the two extents, the ``torch.device`` of this
process, and where the process stands among the ranks. In one process every
(time, ch) cell lives on that device: ``n_time`` time shards are rows of one
batch. Under a process group (``init_distributed``, a process per card, or
several processes on one card or on the CPU) the ranks tile the mesh on a
``(P_t, P_c)`` grid in the JAX mesh's order, time-major: rank
``pt * P_c + pc`` holds the ``n_time / P_t`` consecutive time shards
``pt * L .. pt * L + L - 1`` of the channel rows of group ``pc``. A rank's
halo goes to the rank to its left in its ch column (``left``), by the halo
kernel's push into that rank's window (parallel/peer.py) on a card, by a
send and a receive on the CPU.

``local_block`` cuts a rank's block out of a global ``[B, T]`` stream: the
port's form of placing a stream by a ``PartitionSpec`` (the JAX package's
``channel_sharding`` / ``time_sharding``).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

TIME_AXIS = "time"
CH_AXIS = "ch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_time: int
    n_ch: int
    device: torch.device
    ranks: tuple[int, int] = (1, 1)  # (P_t, P_c): the grid of processes
    rank: int = 0
    group: object = dataclasses.field(default=None, compare=False, repr=False)
    # window buffers shared with the neighbour ranks, one set a shape
    # (parallel/peer.py); empty in one process
    peers: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {TIME_AXIS: self.n_time, CH_AXIS: self.n_ch}

    @property
    def world(self) -> int:
        return self.ranks[0] * self.ranks[1]

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's (time, ch) place on the grid of ranks."""
        return divmod(self.rank, self.ranks[1])

    @property
    def local_time(self) -> int:
        """Time shards a rank holds."""
        return self.n_time // self.ranks[0]

    @property
    def time_shards(self) -> range:
        """The global time shards of this rank, in order."""
        lt = self.local_time
        return range(self.coords[0] * lt, (self.coords[0] + 1) * lt)

    def ch_rows(self, batch: int) -> slice:
        """The rows of a ``batch``-row stream that this rank's ch group holds."""
        if batch % self.ranks[1]:
            raise ValueError(f"{batch} channels do not split over {self.ranks[1]} ch groups")
        per = batch // self.ranks[1]
        return slice(self.coords[1] * per, (self.coords[1] + 1) * per)

    @property
    def left(self) -> int | None:
        """The rank that holds the time block before mine in my ch column."""
        return self.rank - self.ranks[1] if self.coords[0] > 0 else None

    @property
    def right(self) -> int | None:
        """The rank that holds the time block after mine in my ch column."""
        return self.rank + self.ranks[1] if self.coords[0] < self.ranks[0] - 1 else None

    @property
    def holds_last_time(self) -> bool:
        """Whether this rank holds the global last time shard (whose tail is
        the end of the stream)."""
        return self.right is None

    def checked_device(self) -> torch.device:
        """The mesh's device; raises for a GPU mesh on a machine without a
        GPU instead of letting the caller run on the CPU."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the mesh names a GPU; the tests build theirs with "
                'devices=["cpu"]'
            )
        return self.device


def local_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a global [B, T] stream (host or device): the rows
    of its ch group and the columns of its time shards, as one contiguous
    complex64 tensor on the mesh's device. In one process, the whole
    stream."""
    if x.dim() != 2:
        raise ValueError(f"x: expected [B, T], got shape {tuple(x.shape)}")
    b, t = x.shape
    if t % mesh.n_time:
        raise ValueError(f"x: {t} samples do not split into {mesh.n_time} equal time shards")
    t_local = t // mesh.n_time
    shards = mesh.time_shards
    block = x[mesh.ch_rows(b), shards.start * t_local : shards.stop * t_local]
    return block.to(device=mesh.checked_device(), dtype=torch.complex64).contiguous()


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v is None else int(v)


def init_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    device: torch.device | str | None = None,
) -> torch.device | None:
    """Join the process group of a distributed run and return this rank's
    device; a no-op (returning None) for one process.

    Counterpart of ``liquiddsp_tpu.parallel.mesh.init_distributed``. With
    everything left ``None`` it reads ``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR`` / ``MASTER_PORT`` from the environment, as
    ``python -m torch.distributed.run`` sets them. ``device=None`` means this
    rank's card, ``cuda:(LOCAL_RANK % device_count)``, and raises without one;
    the tests pass ``device="cpu"``. ``backend=None`` chooses ``nccl`` when
    every local rank has a card of its own, else ``gloo`` (NCCL refuses two
    ranks on one card, and the CPU has only gloo); the caller prints
    ``torch.distributed.get_backend()``.
    """
    if world_size is None and init_method is None:
        world_size = _env_int("WORLD_SIZE")
    if world_size in (None, 1):
        return None
    if dist.is_initialized():
        raise RuntimeError("init_distributed: this process already belongs to a process group")
    if rank is None:
        rank = _env_int("RANK")
        if rank is None:
            raise ValueError("init_distributed: no rank given and RANK is not set")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: init_distributed puts each rank on a GPU unless the "
                'caller passes device="cpu"'
            )
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = torch.device(device)
    if backend is None:
        local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
        own_card = device.type == "cuda" and local_world <= torch.cuda.device_count()
        backend = "nccl" if own_card else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://", world_size=world_size, rank=rank)
    return device


def make_mesh(
    n_time: int = 1,
    n_ch: int = 1,
    devices: list | None = None,
    ranks: tuple[int, int] | None = None,
) -> Mesh:
    """Build a (time, ch) mesh of ``n_time * n_ch`` logical cells.

    In one process every cell lives on one device: ``devices=None`` means
    the visible CUDA cards (raises without one); the tests pass
    ``devices=["cpu"]``. Several distinct devices raise
    ``NotImplementedError``: a card is a process of its own
    (``init_distributed``).

    Under an initialised process group the ranks tile the mesh on the grid
    ``ranks=(P_t, P_c)``, by default ``(world, 1)``; ``P_t`` must divide
    ``n_time`` and ``P_c`` ``n_ch``. ``devices`` names this rank's one
    device (``None``: its current card). ``ranks=(1, 1)`` builds a
    one-process mesh inside a distributed run.
    """
    if n_time < 1 or n_ch < 1:
        raise ValueError(f"mesh extents must be positive, got ({n_time}, {n_ch})")
    distributed = dist.is_initialized() and dist.get_world_size() > 1 and ranks != (1, 1)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: make_mesh builds its mesh on the GPUs unless "
                'the caller passes devices (the tests pass ["cpu"])'
            )
        devices = (
            [torch.device("cuda", torch.cuda.current_device())] if distributed
            else [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        )
    devs = {torch.device(d) for d in devices}
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    if len(devs) != 1:
        raise NotImplementedError(
            f"a mesh over {len(devs)} devices in one process is not built: run a "
            "process per card (init_distributed) and give each its own device"
        )
    device = devs.pop()
    if not distributed:
        if ranks not in (None, (1, 1)):
            raise ValueError(f"ranks={ranks} needs an initialised process group (init_distributed)")
        return Mesh(n_time=n_time, n_ch=n_ch, device=device)
    world = dist.get_world_size()
    p_t, p_c = ranks if ranks is not None else (world, 1)
    if p_t * p_c != world:
        raise ValueError(f"a grid of {p_t} x {p_c} ranks does not fit {world} processes")
    if n_time % p_t or n_ch % p_c:
        raise ValueError(
            f"a ({n_time}, {n_ch}) mesh does not split over a grid of {p_t} x {p_c} ranks")
    return Mesh(n_time=n_time, n_ch=n_ch, device=device, ranks=(p_t, p_c),
                rank=dist.get_rank(), group=dist.group.WORLD)
