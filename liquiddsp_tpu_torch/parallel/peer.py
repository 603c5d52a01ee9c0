"""Window buffers shared with the neighbour ranks, and the order of a step.

The JAX package's halo kernel pushes each shard's head into the left
neighbour's window by a remote DMA and waits on a receive semaphore
(``liquiddsp_tpu/parallel/halo.py:66-84``). Across processes on a card the
port does the same with CUDA IPC:

- ``PeerWindows``: a rank's window buffers for one shape, exported once, and
  the left rank's buffers mapped into this process. The halo kernel
  (``kernels/halo.halo_windows_into``) writes the rank's first ``ov`` samples
  straight into the tail of the left rank's last window through that
  mapping. Two processes on one card each own a context; a peer card is
  mapped by the same call (``cudaIpcOpenMemHandle`` with peer access).
- The order of a step, which takes the place of the receive semaphore:
  every rank launches its halo kernel, synchronises its stream, meets the
  others at ``dist.barrier()``, and only then decodes its windows. The
  buffers are used in turn (two of them): the push of step n + 1 goes into
  the other buffer, and the push of step n + 2 comes after step n + 1's
  barrier, which the left rank reaches only once its stream has finished
  decoding step n.
- ``recv_right_head``: the plain version's exchange for a CPU mesh, a send
  of the rank's head to the left and a receive of the right rank's head.

The handles travel once a buffer (``all_gather_object`` when the buffers are
made), never once a step. Interprocess CUDA events in place of the host
barrier are a later optimisation (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import reduce_tensor

N_BUFFERS = 2


class PeerWindows:
    """Window buffers ``[L, B_local, T_local + ov]`` complex64 of one rank on
    its card, and the left rank's, mapped into this process by CUDA IPC.

    Made by every rank of the mesh at the same time (a collective)."""

    def __init__(self, mesh, shape: tuple[int, int, int]):
        self.mesh = mesh
        self.own = [torch.empty(shape, dtype=torch.complex64, device=mesh.device)
                    for _ in range(N_BUFFERS)]
        # reduce_tensor carries the allocation's handle and the buffer's
        # offset inside the caching allocator's block. Only a rank with a
        # right neighbour exports: each export waits to be mapped and
        # released once
        mine = None if mesh.right is None else [reduce_tensor(b) for b in self.own]
        handles = [None] * mesh.world
        dist.all_gather_object(handles, mine, group=mesh.group)
        self.left = None
        if mesh.left is not None:
            self.left = [rebuild(*args) for rebuild, args in handles[mesh.left]]
            for b in self.left:
                if tuple(b.shape) != tuple(shape):
                    raise RuntimeError(f"the left rank's windows are {tuple(b.shape)}, mine {shape}")
        self.turn = 0

    def next(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(my window buffer, the left rank's buffer or None) of the next step."""
        i = self.turn
        self.turn = (i + 1) % N_BUFFERS
        return self.own[i], None if self.left is None else self.left[i]

    def arrived(self) -> None:
        """Wait until every rank's push of this step has landed: my stream's
        work is done, and so is every other rank's."""
        torch.cuda.current_stream(self.mesh.device).synchronize()
        dist.barrier(group=self.mesh.group)

    def close(self) -> None:
        """Unmap the left rank's buffers, wait for every rank to do the same,
        then free my own: an exporter keeps its buffers while a peer maps
        them."""
        self.left = None
        torch.cuda.synchronize(self.mesh.device)
        dist.barrier(group=self.mesh.group)
        self.own = []


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
