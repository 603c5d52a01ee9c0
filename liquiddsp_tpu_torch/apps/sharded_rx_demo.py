"""The time-sharded receiver across processes: the launcher, its worker and
a dry run.

Run under PyTorch's launcher, a process a card (or ``--cpu``: gloo
processes on the CPU):

    python -m torch.distributed.run --nproc-per-node N -m liquiddsp_tpu_torch.apps.sharded_rx_demo [--cpu] [--n-time 8] [--ch-groups 1]

Every rank builds the straddle stream of ``dryrun_sharded`` for the four
config classes (on two channels a frame inside every time shard and one
across every shard boundary, the boundaries between processes included),
decodes its own block of it and prints its kernel launches; rank 0 prints
the frames found exactly once, bit-exact against what was sent. Without the
launcher it runs as one process.

``run_job`` is the one code path of a rank. ``worker`` is the function that
``spawn_ranks`` starts in ``world`` processes of its own (the tests and
``chip_smoke.py``), ``main`` the one the launcher starts; both call
``run_job``. On a card the order of a step lives on the card
(parallel/peer.py), so a rank that waits forever shows only as a step that
never ends: ``run_job`` gives each step's results ``STEP_DEADLINE_S``, after
which the rank prints the step and the flags of its shared windows and
exits with code 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import statistics
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.dryrun import CONFIG_CLASSES, N_CH, straddle_stream
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.kernels.halo import (
    halo_windows_dist,
    halo_windows_dist_ref,
    halo_windows_into,
    halo_windows_ref,
)
from liquiddsp_tpu_torch.parallel import peer
from liquiddsp_tpu_torch.parallel.halo import gather_results, sharded_framesync
from liquiddsp_tpu_torch.parallel.mesh import init_distributed, local_block, make_mesh
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.framesync import FrameResults
from liquiddsp_tpu_torch.runtime.distributed_stream import ShardedStreamingRx
from liquiddsp_tpu_torch.utils.metrics import LinkMetrics

STEP_DEADLINE_S = 30.0  # for the results of one step of a rank on a card


@dataclasses.dataclass
class Job:
    """One stream that every rank is handed and decodes its block of."""

    name: str
    cfg: tuple[int, int, int, int]
    x: np.ndarray  # [B, T] complex64: the global stream, the same on every rank
    n_time: int
    n_ch: int = 1
    k: int = 8  # slots a shard
    chunk: int = 0  # > 0: ShardedStreamingRx over chunks of this many samples
    # (starts [B, n], payloads [B, n, P]) of the frames sent: rank 0 counts
    # those found exactly once
    truth: tuple[np.ndarray, np.ndarray] | None = None
    reps: int = 0  # timed repetitions of the push and of the step


def _metrics(m: LinkMetrics) -> dict:
    return {f.name: getattr(m, f.name).item() for f in dataclasses.fields(m)}


def frames_once(res: FrameResults, starts: np.ndarray, payloads: np.ndarray) -> int:
    """Of gathered results on the host, the frames of the truth (absolute
    starts) found exactly once; raises if a valid slot lies on no true start
    (+-1), carries other bytes, or a frame is found twice."""
    found = np.zeros(starts.shape, np.int64)
    pv, st, pay = (getattr(res, n).numpy() for n in ("payload_valid", "start", "payload"))
    for b, k in zip(*np.nonzero(pv)):
        d = np.abs(starts[b] - (int(st[b, k]) + res.epoch))
        i = int(np.argmin(d))
        if d[i] > 1 or not np.array_equal(pay[b, k], payloads[b, i]):
            raise AssertionError(f"row {b}: a valid frame at {int(st[b, k])} was not sent")
        found[b, i] += 1
    if (found > 1).any():
        raise AssertionError(f"{int((found > 1).sum())} frames decoded more than once")
    return int(found.sum())


def _all(mesh, obj) -> list:
    """``obj`` of every rank, in rank order."""
    if mesh.world == 1:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _stuck(mesh, what: str) -> None:
    print(f"rank {mesh.rank}: {what} not done on the card after {STEP_DEADLINE_S:g} s",
          flush=True)
    for pw in mesh.peers.values():
        print(f"rank {mesh.rank}: {pw.status()}", flush=True)
    os._exit(3)


def _settled(mesh, what: str, fn):
    """Run ``fn`` and, on a card, wait until the card has done it, polling
    an event. Past ``STEP_DEADLINE_S`` (also when ``fn`` itself waits on the
    card, as a gloo all-reduce of its results does) the rank prints ``what``
    and the flags of its shared windows and exits with code 3."""
    if mesh.device.type != "cuda":
        return fn()
    watchdog = threading.Timer(STEP_DEADLINE_S, _stuck, args=(mesh, what))
    watchdog.daemon = True
    watchdog.start()
    try:
        out = fn()
        done = torch.cuda.Event()
        done.record()
        while not done.query():
            time.sleep(1e-4)
    finally:
        watchdog.cancel()
    return out


def _counted(mesh, what: str, fn):
    """Run ``fn`` with the kernels' launch counters at 0 just before and read
    just after; returns (its result, every rank's counts)."""
    _settled(mesh, what, lambda: None)
    _cuda.reset_launches()
    out = _settled(mesh, what, fn)
    return out, _all(mesh, dict(_cuda.LAUNCHES))


def _median_ms(mesh, what: str, fn, reps: int) -> float:
    """Median over ``reps`` of the host clock around ``fn``, every rank
    starting together, the card's work done at the end."""
    times = []
    for _ in range(reps):
        if mesh.world > 1:
            dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        _settled(mesh, what, fn)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _events_ms(mesh, what: str, fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median over ``reps`` of CUDA events around what ``fn`` enqueues, all
    queued at once, so that the card never waits for the host; ``flush``, a
    tensor of 512 MB, is zeroed before each to empty the 50 MB L2 cache."""
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]

    def queued():
        for start, end in events:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()

    _settled(mesh, what, queued)
    return statistics.median(start.elapsed_time(end) for start, end in events)


def _kernel_ms(mesh, x_local: torch.Tensor, ov: int, reps: int) -> tuple[float, float]:
    """The halo kernel of a step on a card, its push and its flag included,
    by ``_events_ms`` with the L2 cache flushed before each launch. The
    launches write into buffers and a flag of this rank's own, since the
    shared ones take a launch only inside a step of parallel/peer.py's
    order; on one card the left rank's mapped buffer is the same memory.
    Returns (every rank launching at the same time, each rank alone: in
    turn, while the others wait at a host barrier with nothing queued on the
    card)."""
    n = mesh.local_time
    shape = (n, x_local.shape[0], x_local.shape[1] // n + ov)
    win, into = (torch.empty(shape, dtype=torch.complex64, device=mesh.device) for _ in range(2))
    flags = torch.zeros(2, dtype=torch.int64, device=mesh.device)  # the flag, the block count
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=mesh.device)
    pushes = mesh.left is not None

    def launch():
        halo_windows_into(x_local, n, ov, win, into if pushes else None, mesh.holds_last_time,
                          flags[0] if pushes else None, 1, flags[1] if pushes else None)

    dist.barrier(group=mesh.group)
    together = _events_ms(mesh, "halo kernel timing", launch, reps, flush)
    alone = None
    for r in range(mesh.world):
        dist.barrier(group=mesh.group)
        if mesh.rank == r:
            alone = _events_ms(mesh, "halo kernel timing", launch, reps, flush)
    dist.barrier(group=mesh.group)
    return together, alone


def _push_wait_ms(mesh, x_local: torch.Tensor, ov: int, reps: int) -> float:
    """One step of ``halo_windows_dist`` on a card by ``_events_ms``: CUDA
    events from before its wait on the left rank's ``free`` to after its
    wait on its own ``arrived``, ``reps`` steps queued in a row, as the
    host queues them when it runs ahead."""
    dist.barrier(group=mesh.group)
    return _events_ms(mesh, "push + wait timing", lambda: halo_windows_dist(x_local, mesh, ov),
                      reps)


def run_job(job: Job, mesh) -> dict:
    """Decode this rank's block of ``job``'s stream on ``mesh`` (one process,
    or a rank of an initialised process group). Returns, on every rank,
    every rank's launches and the gathered results in the one-process
    layout, with the metrics summed over the ranks."""
    cfg = FrameConfig(*job.cfg)
    dev = mesh.device
    x = torch.from_numpy(job.x)
    b, t = x.shape
    out = {"name": job.name}
    if job.chunk:
        rx = ShardedStreamingRx(cfg, mesh, batch=b, chunk_len=job.chunk, max_frames_per_shard=job.k)
        steps = []
        for c, pos in enumerate(range(0, t, job.chunk)):
            (res, m), counts = _counted(mesh, f"{job.name} chunk {c}",
                                        lambda: rx.step(x[:, pos : pos + job.chunk]))
            steps.append({"res": gather_results(res, mesh), "metrics": _metrics(m),
                          "launches": counts})
        out["steps"] = steps
        out["launches"] = [{k: sum(st["launches"][r][k] for st in steps) for k in _cuda.LAUNCHES}
                           for r in range(mesh.world)]
        return out
    ov = fs.FrameSpec(cfg).frame_samples - 1
    x_dev = x.to(dev)
    x_local = local_block(x_dev, mesh)
    # the halo kernel's push across processes (on the CPU, the exchange of
    # the plain version) against the plain version of the whole stream
    win = _settled(mesh, f"{job.name} windows", lambda: halo_windows_dist(x_local, mesh, ov).clone())
    shards = mesh.time_shards
    ref = halo_windows_ref(x_dev[mesh.ch_rows(b)], mesh.n_time, ov)[shards.start : shards.stop]
    exact = _all(mesh, bool(torch.equal(win, ref)))
    if not all(exact):
        raise AssertionError(f"{job.name}: the windows of ranks {exact} differ from halo_windows_ref")
    out["windows_exact"] = exact
    out["windows_shape"] = tuple(win.shape)
    step = lambda: sharded_framesync(x_dev, cfg, mesh, max_frames_per_shard=job.k)
    res, out["launches"] = _counted(mesh, f"{job.name} step", step)
    # the samples of a channel's stream, counted once: by ch group 0
    samples = x_local.shape[1] if mesh.coords[1] == 0 else 0
    out["metrics"] = _metrics(LinkMetrics.from_results(res, samples).psum(mesh))
    out["res"] = gather_results(res, mesh)
    if job.reps:
        if dev.type == "cuda" and mesh.world > 1:
            together, alone = _kernel_ms(mesh, x_local, ov, 4 * job.reps)
            out["kernel_ms"], out["kernel_alone_ms"] = _all(mesh, together), _all(mesh, alone)
            out["push_wait_ms"] = _all(mesh, _push_wait_ms(mesh, x_local, ov, job.reps))

            def plain():  # the plain version on the card, the heads exchanged by gloo on the host
                head = peer.recv_right_head(x_local[:, :ov].cpu(), mesh, ov)
                halo_windows_dist_ref(x_local, mesh.local_time, ov, None if head is None else head.to(dev))

            out["plain_ms"] = _all(mesh, _median_ms(mesh, "plain halo", plain, job.reps))
        out["step_ms"] = _all(mesh, _median_ms(mesh, f"{job.name} step", step, job.reps))
    if job.truth is not None:
        out["found"] = frames_once(out["res"], *job.truth)
    return out


def ready_kernels(dev: torch.device, rank: int) -> None:
    """Rank 0 builds the kernel library (a process that finds it built
    reuses it) before any rank loads it."""
    if dev.type != "cuda":
        return
    if rank == 0:
        _cuda.lib()
    dist.barrier()
    _cuda.lib()


def worker(rank: int, world: int, init_method: str, device: str, ranks: tuple[int, int],
           jobs: list[Job], out_path: str) -> None:
    """One rank of ``spawn_ranks``: join the group, run every job, and on
    rank 0 save the results to ``out_path``."""
    dev = init_distributed(init_method, world, rank, device=device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    ready_kernels(dev, rank)
    outs = []
    for job in jobs:
        mesh = make_mesh(job.n_time, job.n_ch, devices=[dev], ranks=ranks)
        outs.append(run_job(job, mesh))
        peer.release(mesh)
        print(f"rank {rank}/{world} ({dist.get_backend()} on {dev}): {job.name}, shards "
              f"{list(mesh.time_shards)} of {job.n_time}, launches {outs[-1]['launches'][rank]}",
              flush=True)
    if rank == 0:
        torch.save(outs, out_path)
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, jobs: list[Job], device: str, ranks: tuple[int, int] | None = None,
                timeout_s: float = 300.0) -> list[dict]:
    """Run ``jobs`` in ``world`` new processes (the spawn start method), a
    TCP rendezvous on a free localhost port; every rank on ``device``
    (``"cpu"``, or ``"cuda:0"`` for ranks that share a card). Returns rank
    0's results. A failing rank raises here; ranks still running after
    ``timeout_s`` are killed and ``TimeoutError`` is raised."""
    ranks = ranks or (world, 1)
    with tempfile.TemporaryDirectory() as td:
        out_path = os.path.join(td, "rank0.pt")
        ctx = mp.start_processes(
            worker, args=(world, f"tcp://127.0.0.1:{free_port()}", device, ranks, jobs, out_path),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks did not finish in {timeout_s:g} s")
        return torch.load(out_path, weights_only=False)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo processes on the CPU")
    ap.add_argument("--n-time", type=int, default=8, help="time shards of the mesh")
    ap.add_argument("--ch-groups", type=int, default=1, help="P_c: ranks across the 2 channels")
    args = ap.parse_args(argv)
    dev = init_distributed(device="cpu" if args.cpu else None)
    if dev is None:  # one process
        dev = resolve_device("cpu" if args.cpu else None)
        rank, world, backend = 0, 1, "none"
    else:
        rank, world, backend = dist.get_rank(), dist.get_world_size(), dist.get_backend()
        ready_kernels(dev, rank)
    ranks = (world // args.ch_groups, args.ch_groups) if world > 1 else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    outs = []
    for name, cfg in CONFIG_CLASSES:
        x, expected, _ = straddle_stream(cfg, args.n_time, gen, dev)
        keys = sorted(expected)
        starts = np.array([s for _, s in keys]).reshape(N_CH, -1)
        payloads = np.stack([expected[k].numpy() for k in keys]).reshape(N_CH, starts.shape[1], -1)
        job = Job(name, (cfg.modulation, cfg.inner_code, cfg.outer_code, cfg.payload_len),
                  x.cpu().numpy(), args.n_time, N_CH, k=3, truth=(starts, payloads))
        mesh = make_mesh(args.n_time, N_CH, devices=[dev], ranks=ranks)
        out = run_job(job, mesh)
        peer.release(mesh)
        outs.append(out)
        print(f"rank {rank}/{world} ({backend} on {dev}): {name} shards "
              f"{list(mesh.time_shards)} of {args.n_time}, launches {out['launches'][rank]}", flush=True)
        if rank == 0:
            if out["found"] != starts.size:
                raise AssertionError(f"{name}: {out['found']} of {starts.size} frames found")
            print(f"{name}: {out['found']}/{starts.size} frames found exactly once and bit-exact "
                  f"across {world} process(es), {N_CH * (args.n_time - 1)} shard boundaries "
                  f"straddled", flush=True)
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
    return outs


if __name__ == "__main__":
    main()
