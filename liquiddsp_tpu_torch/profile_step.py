"""Where one receiver step spends its time on the GPU.

    python3 -m liquiddsp_tpu_torch.profile_step [--out DIR]

For both receiver configs at 64 x 65,536 samples it prints, with the card's
name and power limit: the time of each stage (host clock around work that
ends in a synchronise), the whole step, the device-busy share of the step and
the kernels that take the most device time (torch.profiler), and the peak
device memory. With ``--out`` it also writes these numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.phy import detector, framesync
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.tables import phy_tables
from liquiddsp_tpu_torch.streams import tiled_stream

BATCH, BLOCK = 64, 65536


def _timed(fn, reps: int = 5):
    out = None
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def profile_config(cfg: FrameConfig, snr_db: float, dev, gen) -> dict:
    x, _, _, k = tiled_stream(cfg, snr_db, BATCH, BLOCK, gen, dev)
    tables = phy_tables(cfg, dev)
    spec = fs.FrameSpec(cfg)
    framesync.framesync_fixed(x, cfg, k, device=dev)  # warm-up

    det, t_detect = _timed(lambda: detector.detect(x, k, fine=False, tables=tables, device=dev))
    (det, syms), t_recover = _timed(
        lambda: framesync.recover_candidates(x, det, spec.frame_syms, tables))
    sc, t_sync = _timed(lambda: framesync.sync_symbols(syms, tables))
    syms2, fields, evm_lin, hdr_ref = sc
    _, t_payload = _timed(
        lambda: framesync._finish_fixed(det, syms2, fields, evm_lin, hdr_ref, cfg, tables))
    torch.cuda.reset_peak_memory_stats()
    _, t_step = _timed(lambda: framesync.framesync_fixed(x, cfg, k, device=dev))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        framesync.framesync_fixed(x, cfg, k, device=dev)
        torch.cuda.synchronize()
        t_prof = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
           and e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.device_time_total)[:8]
    return {
        "config": [cfg.modulation, cfg.inner_code, cfg.outer_code, cfg.payload_len],
        "snr_db": snr_db, "max_frames": k,
        "stage_ms": {"detect": t_detect, "extract+fine_cfo+recover": t_recover,
                     "eq+carrier+header": t_sync, "payload": t_payload},
        "step_ms": t_step, "samples_per_s": BATCH * BLOCK / (t_step * 1e-3),
        "profiled_step_ms": t_prof, "device_busy_ms": dev_ms,
        "device_busy_share_of_profiled_step": dev_ms / t_prof,
        "device_kernel_launches": int(sum(e.count for e in evs)),
        "top_device_kernels": [
            {"name": e.key[:80], "ms": e.device_time_total / 1e3, "count": e.count} for e in top],
        "peak_device_memory_mb": peak_mb,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None, help="directory for profile_step.json")
    args = ap.parse_args()
    dev = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    report = {"card": card, "torch": torch.__version__, "configs": [
        profile_config(FrameConfig(1, 0, 0, 64), 20.0, dev, gen),
        profile_config(FrameConfig(1, 1, 1, 64), 10.0, dev, gen),
    ]}
    print(json.dumps(report, indent=1))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "profile_step.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
