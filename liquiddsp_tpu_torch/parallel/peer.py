"""Window buffers shared with the neighbour ranks, and the order of a step.

The JAX package's halo kernel pushes each shard's head into the left
neighbour's window by a remote DMA and waits, in the kernel, on a receive
semaphore until the right neighbour's head has landed in its own window
(``liquiddsp_tpu/parallel/halo.py:66-85``). Across processes on a card the
port does the same with CUDA IPC and flags on the card:

- ``PeerWindows``: a rank's window buffers for one shape and a block of
  flags beside them, exported once, and the left rank's buffers and flags
  mapped into this process. The halo kernel
  (``kernels/halo.halo_windows_into``) writes the rank's first ``ov`` samples
  straight into the tail of the left rank's last window through that
  mapping. Two processes on one card each own a context; a peer card is
  mapped by the same call (``cudaIpcOpenMemHandle`` with peer access).
- The order of a step (``StepOrder``; ``kernels/halo.halo_windows_dist``
  issues it), which takes the place of the receive semaphore. The two
  buffers are used in turn: step ``n`` takes buffer ``i = n % 2`` for its
  ``v``-th use, ``v = n // 2 + 1``. Two monotone counters a buffer live in
  the flags of the rank that receives into it: ``arrived[i]``, written by
  the right rank once its push has landed, and ``free[i]``, written by the
  owner once it has stopped reading. A rank's stream, at step ``n``:

  1. with a right rank: store ``free[i] = v - 1`` (the use of step n - 2 is
     over: everything it enqueued, its decode included, came before);
  2. with a left rank: wait until the left rank's ``free[i] >= v - 1``;
  3. the halo kernel: the local copy, and the push into the left rank's
     buffer ``i``;
  4. with a left rank: the kernel's last block stores ``arrived[i] = v`` in
     the left rank's flags, after every write of the push;
  5. with a right rank: wait until its own ``arrived[i] >= v``; then the
     windows may be read.

  Stores and waits are kernels (``csrc/halo.cu``); no wait depends on a
  store that comes later in the writer's own stream, so no step can wait
  for itself, provided every rank runs the same steps. Nothing in a step
  synchronises the host or meets the other ranks: the host runs ahead as in
  one process. The windows a step returns stay valid until the step after
  next.
- ``recv_right_head``: the plain version's exchange for a CPU mesh, a send
  of the rank's head to the left and a receive of the right rank's head.

The handles travel once a buffer (``all_gather_object`` when the buffers are
made), never once a step.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import reduce_tensor

N_BUFFERS = 2
# a rank's flags, int64 words: arrived[i], free[i], the halo kernel's block
# count, and padding to 64 bytes
ARRIVED, FREE, COUNT, FLAG_WORDS = 0, N_BUFFERS, 2 * N_BUFFERS, 8


@dataclasses.dataclass(frozen=True)
class Step:
    """One step of one rank, in its stream's order; None: not done."""

    n: int  # the step, from 0
    buf: int  # the buffer it takes
    use: int  # that buffer's use, from 1
    release: int | None  # 1. stored into my free[buf]
    wait_free: int | None  # 2. awaited in the left rank's free[buf]
    arrive: int | None  # 4. stored into the left rank's arrived[buf] after the push
    wait_arrived: int | None  # 5. awaited in my arrived[buf] before my windows are read


class StepOrder:
    """Which buffer each step of a rank takes, and which values it stores
    and waits for (the module's docstring), for a rank with or without
    neighbours."""

    def __init__(self, has_left: bool, has_right: bool):
        self.has_left, self.has_right = has_left, has_right
        self.n = 0

    def next(self) -> Step:
        n = self.n
        self.n += 1
        buf, use = n % N_BUFFERS, n // N_BUFFERS + 1
        left, right = self.has_left, self.has_right
        return Step(n, buf, use,
                    release=use - 1 if right else None,
                    wait_free=use - 1 if left else None,
                    arrive=use if left else None,
                    wait_arrived=use if right else None)


class PeerWindows:
    """Window buffers ``[L, B_local, T_local + ov]`` complex64 of one rank on
    its card with their flags, and the left rank's, mapped into this process
    by CUDA IPC.

    Made by every rank of the mesh at the same time (a collective)."""

    def __init__(self, mesh, shape: tuple[int, int, int]):
        self.mesh = mesh
        self.own = [torch.empty(shape, dtype=torch.complex64, device=mesh.device)
                    for _ in range(N_BUFFERS)]
        # the counters start at 0, and the zeros are on the card before any
        # peer maps them
        self.flags = torch.zeros(FLAG_WORDS, dtype=torch.int64, device=mesh.device)
        torch.cuda.synchronize(mesh.device)
        # reduce_tensor carries the allocation's handle and the tensor's
        # offset inside the caching allocator's block. Only a rank with a
        # right neighbour exports: each export waits to be mapped and
        # released once
        mine = None
        if mesh.right is not None:
            mine = ([reduce_tensor(b) for b in self.own], reduce_tensor(self.flags))
        handles = [None] * mesh.world
        dist.all_gather_object(handles, mine, group=mesh.group)
        self.left = self.left_flags = None
        if mesh.left is not None:
            bufs, (rebuild, args) = handles[mesh.left]
            self.left = [rebuild_buf(*buf_args) for rebuild_buf, buf_args in bufs]
            self.left_flags = rebuild(*args)
            for b in self.left:
                if tuple(b.shape) != tuple(shape):
                    raise RuntimeError(f"the left rank's windows are {tuple(b.shape)}, mine {shape}")
        self.order = StepOrder(mesh.left is not None, mesh.right is not None)

    def next(self) -> Step:
        """The next step. Whoever takes it issues all of it (as
        ``kernels/halo.halo_windows_dist`` does): a neighbour waits for every
        store it names."""
        return self.order.next()

    def status(self) -> str:
        """The steps taken and both ranks' counters, copied on a stream of
        their own: a wait may hold the current stream."""
        side = torch.cuda.Stream(self.mesh.device)
        with torch.cuda.stream(side):
            mine = self.flags.to("cpu").tolist()
            left = None if self.left_flags is None else self.left_flags.to("cpu").tolist()
        show = lambda f: {"arrived": f[ARRIVED:FREE], "free": f[FREE:COUNT], "count": f[COUNT]}
        n = self.order.n
        last = f"step {n - 1} on buffer {(n - 1) % N_BUFFERS}" if n else "no step yet"
        return (f"windows {tuple(self.own[0].shape)}: {last}; my flags {show(mine)}, the left "
                f"rank's {None if left is None else show(left)}")

    def close(self) -> None:
        """Unmap the left rank's buffers and flags, wait for every rank to do
        the same, then free my own: an exporter keeps its buffers while a
        peer maps them."""
        self.left = self.left_flags = None
        torch.cuda.synchronize(self.mesh.device)
        dist.barrier(group=self.mesh.group)
        self.own = []
        self.flags = None


def peer_windows(mesh, shape: tuple[int, int, int]) -> PeerWindows:
    """The mesh's shared window buffers of this shape, made at first use."""
    pw = mesh.peers.get(shape)
    if pw is None:
        pw = mesh.peers[shape] = PeerWindows(mesh, shape)
    return pw


def release(mesh) -> None:
    """Free the mesh's shared window buffers: every rank calls it together,
    before the process group is destroyed."""
    for pw in mesh.peers.values():
        pw.close()
    mesh.peers.clear()


def recv_right_head(x_local: torch.Tensor, mesh, ov: int) -> torch.Tensor | None:
    """The plain version's exchange on a CPU mesh: send my first ``ov``
    samples to the left rank, receive the right rank's (None when I hold the
    global last shard). Complex samples travel as float32 pairs."""
    b = x_local.shape[0]
    reqs = []
    if mesh.left is not None:
        head = torch.view_as_real(x_local[:, :ov].contiguous()).contiguous()
        reqs.append(dist.isend(head, mesh.left, group=mesh.group))
    got = None
    if mesh.right is not None:
        got = torch.empty((b, ov, 2), dtype=torch.float32, device=x_local.device)
        reqs.append(dist.irecv(got, mesh.right, group=mesh.group))
    for r in reqs:
        r.wait()
    return None if got is None else torch.view_as_complex(got)
