"""Supervised multi-worker streaming RX demo.

Counterpart of ``apps/supervised_rx_demo.py`` on this package. It spawns N
worker processes, each decoding its own channel's chunked stream with
``StreamingRx`` under the heartbeat ``Supervisor`` (runtime/supervisor.py).
Each worker checkpoints its stream carry and its tally of decoded frames
atomically after every chunk; with ``--kill``, one worker exits mid-stream
and the supervisor respawns it, after which it resumes from the checkpoint
with exactly-once accounting (a frame straddling the crash point, its head
living only in the checkpointed carry, still decodes exactly once). The
workers run on the GPU (every one on ``cuda:0`` of a one-card machine), or
on the CPU with ``--cpu``:

    python -m liquiddsp_tpu_torch.apps.supervised_rx_demo [--cpu] --workers 2 --chunks 6 --kill 0

A worker is this module run with ``--worker``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.runtime.stream import StreamingRx
from liquiddsp_tpu_torch.runtime.supervisor import (
    Heartbeat,
    Supervisor,
    WorkerSpec,
    load_stream_state,
    save_stream_state,
)

CHUNK = 2048
REPO = Path(__file__).resolve().parents[2]


def run_worker(work_dir: str, widx: int, n_chunks: int, die_after: int, device: str) -> None:
    """One supervised worker: decode channel ``widx``'s stream chunk by chunk
    from its checkpoint on, checkpoint after every chunk, exit once after
    chunk ``die_after`` (-1: never), and write the tally at the end."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the workers share the host's cores
    hb = Heartbeat(os.path.join(work_dir, f"hb{widx}"))
    ckpt = os.path.join(work_dir, f"state{widx}.npz")

    cfg = FrameConfig(modulation=1, inner_code=0, outer_code=0, payload_len=64)
    rng = np.random.default_rng(1000 + widx)
    payloads = rng.integers(0, 256, (n_chunks, 64), dtype=np.uint8)
    frames = framegen.framegen(torch.from_numpy(payloads), cfg, device=dev).cpu().numpy()
    f = frames.shape[1]
    stream = np.zeros((1, n_chunks * CHUNK), dtype=np.complex64)
    starts = [300] + [CHUNK * (i + 1) - f // 2 for i in range(n_chunks - 1)]
    for s, fr in zip(starts, frames):
        stream[0, s : s + f] = fr
    sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / (2 * 10 ** 2.0))
    stream += sigma * (
        rng.standard_normal(stream.shape) + 1j * rng.standard_normal(stream.shape)
    ).astype(np.complex64)

    rx = StreamingRx(cfg, batch=1, chunk_len=CHUNK, device=dev)
    extra = load_stream_state(ckpt, rx)
    decoded = [int(s) for s in extra["decoded"]] if extra else []
    resumed = extra is not None

    while (i := rx._samples_consumed // CHUNK) < n_chunks:
        hb.beat()
        res = rx.step(stream[:, i * CHUNK : (i + 1) * CHUNK])
        valid = res.payload_valid[0].cpu().numpy()
        start = res.start[0].cpu().numpy()
        decoded += [res.epoch + int(start[k]) for k in np.nonzero(valid)[0]]
        save_stream_state(ckpt, rx, decoded=np.asarray(decoded, dtype=np.int64))
        died = os.path.join(work_dir, f"died{widx}")
        if die_after >= 0 and i + 1 == die_after and not os.path.exists(died):
            Path(died).write_text("1")
            print(f"worker {widx}: simulated crash after chunk {i}", flush=True)
            os._exit(9)

    with open(os.path.join(work_dir, f"tally{widx}.json"), "w") as fh:
        json.dump({"decoded": sorted(decoded), "expected": sorted(starts), "resumed": resumed}, fh)
    print(f"worker {widx} on {dev}: done, {len(decoded)}/{len(starts)} frames"
          + (" (resumed from checkpoint)" if resumed else "")
          + f", launches of this process {dict(_cuda.LAUNCHES)}", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the workers on the CPU")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--kill", type=int, default=-1,
                    help="worker index to crash once mid-stream (-1: none)")
    ap.add_argument("--worker", nargs=4, metavar=("DIR", "INDEX", "CHUNKS", "DIE_AFTER"),
                    help="run as one worker (the supervisor starts these)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda:0"
    if args.worker:
        wd, widx, n_chunks, die_after = args.worker
        run_worker(wd, int(widx), int(n_chunks), int(die_after), device)
        return {}
    resolve_device("cpu" if args.cpu else None)  # raises here, not in the workers, without a card
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as td:
        specs = [
            WorkerSpec(
                name=f"rx{w}",
                argv=[sys.executable, "-m", "liquiddsp_tpu_torch.apps.supervised_rx_demo",
                      *(["--cpu"] if args.cpu else []), "--worker", td, str(w),
                      str(args.chunks), str(args.chunks // 2 if w == args.kill else -1)],
                heartbeat_path=os.path.join(td, f"hb{w}"),
                stale_after_s=120.0,
                max_restarts=2,
            )
            for w in range(args.workers)
        ]
        sup = Supervisor(
            specs, on_event=lambda n, ev, d: print(f"[supervisor] {n}: {ev} ({d})", flush=True),
            env=env,
        )
        sup.start()
        summary = sup.run(poll_interval_s=0.25, timeout_s=900)
        total = ok = 0
        for w in range(args.workers):
            with open(os.path.join(td, f"tally{w}.json")) as fh:
                tally = json.load(fh)
            match = sum(1 for s in tally["expected"] if any(abs(s - g) <= 1 for g in tally["decoded"]))
            dup = len(tally["decoded"]) - len(set(tally["decoded"]))
            total += len(tally["expected"])
            ok += match
            print(f"worker {w}: {match}/{len(tally['expected'])} frames, "
                  f"{dup} duplicates, resumed={tally['resumed']}")
            if dup:
                raise RuntimeError(f"worker {w}: exactly-once violated ({dup} duplicates)")
        restarts = [s["restarts"] for s in summary]
        print(f"total: {ok}/{total} frames decoded exactly once; restarts={restarts}")
        if ok != total:
            raise RuntimeError(f"{total - ok} frames were not decoded")
    return {"ok": ok, "total": total, "restarts": restarts}


if __name__ == "__main__":
    main()
