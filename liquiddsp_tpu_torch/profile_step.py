"""Where one receiver step spends its time on the GPU.

    python3 -m liquiddsp_tpu_torch.profile_step [--sharded] [--flexrx] [--stream] [--resampled] [--out DIR]

For both receiver configs at 64 x 65,536 samples it prints, with the card's
name and power limit: the time of each stage (host clock around work that
ends in a synchronise), the whole step, the device-busy share of the step and
the kernels that take the most device time (torch.profiler), and the peak
device memory. With ``--sharded`` it profiles, after the block receiver and
in the same process, the time-sharded receiver on the same number of samples
as 8 channels x 524,288 in 8 time shards (the halo windows are one more
stage), and counts the device launches of one Reed-Solomon decode at the
shape a (10,0,2) step gives it. With ``--flexrx`` it profiles the
self-describing receiver on a mixed-config block (64 channels, a config each,
payload 64, 12 frames a channel: every frame on the sample-clock-drift path)
and a framesync_fixed step on 64 x 65,536 samples of 2650-symbol QAM16
frames stretched by +-50 ppm (the sample-clock-drift path; the launches of
its symbol-recovery stage are those of an SFO block). With ``--stream`` it
profiles the continuous streaming receiver (``StreamingRx``: one step and one
superstep of 5 chunks of 64 x 65,536, both configs, as replayed CUDA graphs,
and the step's eager body beside them) and ten generations of the closed
adaptation loop at its defaults (64 channels, payload 32, 15 dB). Each
profile counts the graph replays and the host's CUDA API calls beside the
device's kernel launches (a replay is one graph launch on the host).
With ``--resampled`` it profiles the resampled receiver step of the reference
bench (BASELINE config 3, both configs): 64 channels x 65,536 in four
sample-clock groups, ``arbitrary_groups`` with bf16 planes at rank 4 as a
stage of its own, then framesync_fixed; and it times ``ops.fir.conv_full``
(one ``conv1d``, TF32 off) against one shifted multiply-add a tap at 64 x
65,536 with the 65-tap ``design_lowpass``, and the AGC and NCO ops (the
per-sample loops agc_scan and pll_track at 8,192 samples). With ``--out`` it
also writes these numbers as JSON.
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
from liquiddsp_tpu_torch import config_space as cs
from liquiddsp_tpu_torch.adapt_loop import adapt_loop
from liquiddsp_tpu_torch.core import program
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.kernels.halo import halo_windows
from liquiddsp_tpu_torch.ops import agc, fir, nco, resample
from liquiddsp_tpu_torch.ops.fec import rs
from liquiddsp_tpu_torch.parallel.halo import sharded_framesync
from liquiddsp_tpu_torch.parallel.mesh import make_mesh
from liquiddsp_tpu_torch.phy import detector, framesync
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.tables import phy_tables
from liquiddsp_tpu_torch.runtime import blocks
from liquiddsp_tpu_torch.runtime.blocks import FlexRx
from liquiddsp_tpu_torch.runtime.stream import StreamingRx
from liquiddsp_tpu_torch.streams import (
    RESAMPLED_PPMS,
    long_stream,
    resampled_stream,
    shard_slots,
    stretched_stream,
    tiled_stream,
)

BATCH, BLOCK = 64, 65536
SH_BATCH, SH_TOTAL, SH_NTIME = 8, 524288, 8  # the same samples as long channels


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


def _device_events(prof) -> list:
    return [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]


def _device_profile(fn) -> dict:
    """One run of ``fn`` under torch.profiler: host-clock ms, device-busy ms,
    device kernel launches, the kernels that take the most device time, the
    host's CUDA API calls (the closing synchronise left out) and the graph
    replays of ``core.program`` in it. The profiler shows a replay as one
    graph launch on the host; the kernels it runs are the device events."""
    from torch.profiler import ProfilerActivity, profile

    replays = program.STATS["replays"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t_prof = (time.perf_counter() - t0) * 1e3
    evs = _device_events(prof)
    dev_ms = sum(e.device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.device_time_total)[:8]
    api = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("cu")
           and "Synchronize" not in e.key}
    return {
        "profiled_step_ms": t_prof, "device_busy_ms": dev_ms,
        "device_busy_share_of_profiled_step": dev_ms / t_prof,
        "device_kernel_launches": int(sum(e.count for e in evs)),
        "graph_replays": program.STATS["replays"] - replays,
        "host_cuda_calls": int(sum(api.values())),
        "host_cuda_calls_by_name": dict(sorted(api.items(), key=lambda kv: -kv[1])[:8]),
        "top_device_kernels": [
            {"name": e.key[:80], "ms": e.device_time_total / 1e3, "count": e.count} for e in top],
    }


def profile_config(cfg: FrameConfig, snr_db: float, dev, gen, sharded: bool = False,
                   ppm: float = 0.0, resampled: bool = False) -> dict:
    """One receiver step of ``cfg``; ``ppm`` stretches the block's rows by
    +-ppm (``streams.stretched_stream``); ``resampled`` puts bench.py's
    per-channel resampler ahead of the receiver (``streams.resampled_stream``,
    the resampler a stage of its own)."""
    tables = phy_tables(cfg, dev)
    spec = fs.FrameSpec(cfg)
    track = spec.frame_syms >= framesync.SFO_AUTO_SYMS  # framesync_fixed's "auto"
    stage_ms, extra = {}, {}
    if sharded:
        xs, _, _, _ = long_stream(cfg, snr_db, SH_BATCH, SH_TOTAL, gen, dev)
        mesh = make_mesh(n_time=SH_NTIME, n_ch=1, devices=[dev])
        t_local, f = SH_TOTAL // SH_NTIME, spec.frame_samples
        k = shard_slots(cfg, t_local)
        step = lambda: sharded_framesync(xs, cfg, mesh, max_frames_per_shard=k)
        step()  # warm-up (builds the kernels at first use)
        windows, stage_ms["halo windows"] = _timed(lambda: halo_windows(xs, SH_NTIME, f - 1))
        x = windows.reshape(SH_NTIME * SH_BATCH, t_local + f - 1)
    elif resampled:
        xs, _, _, k, rates = resampled_stream(cfg, snr_db, BATCH, BLOCK, RESAMPLED_PPMS, gen, dev)
        resampler = lambda: resample.arbitrary_groups(
            xs, rates, BLOCK, compute_dtype=torch.bfloat16, rank=4).to(torch.complex64)
        step = lambda: framesync.framesync_fixed(resampler(), cfg, k, device=dev)
        step()  # warm-up
        x, stage_ms["resample"] = _timed(resampler)
        extra["resample_stage_device_launches"] = _device_profile(resampler)["device_kernel_launches"]
    else:
        if ppm:
            x, _, _, k = stretched_stream(cfg, snr_db, ppm, BATCH, BLOCK, gen, dev)
        else:
            x, _, _, k = tiled_stream(cfg, snr_db, BATCH, BLOCK, gen, dev)
        step = lambda: framesync.framesync_fixed(x, cfg, k, device=dev)
        step()  # warm-up

    det, t_detect = _timed(lambda: detector.detect(x, k, fine=False, tables=tables, device=dev))
    recover = lambda: framesync.recover_candidates(x, det, spec.frame_syms, tables,
                                                   track_sfo=track)
    (det, syms), t_recover = _timed(recover)
    recover_launches = _device_profile(recover)["device_kernel_launches"]
    sc, t_sync = _timed(lambda: framesync.sync_symbols(syms, tables))
    syms2, fields, evm_lin, hdr_ref = sc
    _, t_payload = _timed(
        lambda: framesync._finish_fixed(det, syms2, fields, evm_lin, hdr_ref, cfg, tables))
    torch.cuda.reset_peak_memory_stats()
    _, t_step = _timed(step)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    return {
        "config": [cfg.modulation, cfg.inner_code, cfg.outer_code, cfg.payload_len],
        "path": ("sharded_framesync" if sharded else
                 "arbitrary_groups + framesync_fixed" if resampled else "framesync_fixed"),
        "local_receiver_shape": list(x.shape), "sample_clock_offset_ppm": ppm,
        "symbol_recovery": "sample-clock-drift path" if track else "recover kernel",
        "snr_db": snr_db, "max_frames": k,
        "stage_ms": {**stage_ms, "detect": t_detect, "extract+fine_cfo+recover": t_recover,
                     "eq+carrier+header": t_sync, "payload": t_payload},
        "recover_stage_device_launches": recover_launches, **extra,
        "step_ms": t_step, "samples_per_s": BATCH * BLOCK / (t_step * 1e-3),
        **_device_profile(step),
        "peak_device_memory_mb": peak_mb,
    }


def profile_flexrx(dev, payload_len: int = 64, seed: int = 7) -> dict:
    """FlexRx on chip_smoke.py's P4 block: 64 channels x 65,536 samples, a
    config each (``config_space.mixed_stream``), at max_payload_len
    ``payload_len``: the front end alone, the whole block, the block with
    the speculative decode of the commanded configs, and one block under the
    profiler."""
    cfgs, x, payloads = cs.mixed_stream(BATCH, BLOCK, payload_len, seed, dev)
    n_frames = payloads.shape[1]
    rx = FlexRx(max_payload_len=payload_len, max_frames_per_block=n_frames + 2, device=dev)
    infos = rx.work(x)  # warm-up (builds the kernels at first use)
    ok, false = cs.frame_outcomes(infos, cfgs, payloads, payload_len)
    _, t_front = _timed(lambda: framesync.sync_common(
        x, rx.n_syms, rx.max_frames, rx.threshold, tables=rx.tables, device=dev))
    torch.cuda.reset_peak_memory_stats()
    _, t_step = _timed(lambda: rx.work(x))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    expected = [(m, i, o, payload_len) for m, i, o in cfgs]
    _, t_spec = _timed(lambda: rx.work_complete(rx.work_submit(x, expected_configs=expected)))
    key = (x.shape[0], x.shape[1], rx.n_syms, rx.max_frames, rx.threshold, dev)
    _, t_front_graph = _timed(lambda: blocks._SYNC(key, x, device=dev))
    return {
        "path": "FlexRx", "shape": list(x.shape), "max_payload_len": payload_len,
        "symbol_buffer": rx.n_syms, "slots_per_row": rx.max_frames,
        "config_groups": len(set(cfgs)),
        "frames_sent": int(ok.size), "frames_decoded_bit_exact": int(ok.sum()),
        "false_crc_passes": int(false.sum()),
        "stage_ms": {"front end (sync_common), eager": t_front,
                     "front end, its graph replayed": t_front_graph},
        "step_ms": t_step, "speculative_step_ms": t_spec,
        "samples_per_s": BATCH * BLOCK / (t_step * 1e-3),
        **_device_profile(lambda: rx.work(x)),
        "peak_device_memory_mb": peak_mb,
    }


def profile_stream(cfg: FrameConfig, snr_db: float, dev, gen, per_launch: int = 5) -> dict:
    """StreamingRx at the reference bench's streaming shape: one step (the
    median over 10 chunks) and one superstep of ``per_launch`` chunks, each
    also under the profiler, replayed as their graphs; and the step's eager
    body on the same chunks, for comparison."""
    n = 2 * per_launch
    x, _, _, _ = long_stream(cfg, snr_db, BATCH, n * BLOCK, gen, dev)
    k = shard_slots(cfg, BLOCK)  # the bench's (chunk_len + f - 1) // period + 2
    rx = StreamingRx(cfg, BATCH, BLOCK, max_frames_per_chunk=k, device=dev)
    rx.run(x)  # warm-up (builds the kernels at first use)
    rx.reset()
    chunks = iter(range(n))
    _, t_step = _timed(lambda: rx.step(x[:, next(chunks) * BLOCK :][:, :BLOCK]), reps=n)
    rx.reset()
    step_prof = _device_profile(lambda: rx.step(x[:, :BLOCK]))
    rx.reset()
    _, t_super = _timed(lambda: rx.superstep(x[:, : per_launch * BLOCK]), reps=3)
    rx.reset()
    super_prof = _device_profile(lambda: rx.superstep(x[:, : per_launch * BLOCK]))

    rx_e = StreamingRx(cfg, BATCH, BLOCK, max_frames_per_chunk=k, device=dev)

    def eager(c: int):
        base = torch.full((), rx_e._base(), dtype=torch.int64, device=dev)
        rx_e.program.body(("step", k))(x[:, c * BLOCK : (c + 1) * BLOCK], base)
        rx_e._samples_consumed += BLOCK

    chunks = iter(range(n))
    _, t_eager = _timed(lambda: eager(next(chunks)), reps=n)
    rx_e.reset()
    eager_prof = _device_profile(lambda: eager(0))
    return {
        "config": [cfg.modulation, cfg.inner_code, cfg.outer_code, cfg.payload_len],
        "window": [BATCH, BLOCK + rx.overlap], "max_frames": k, "snr_db": snr_db,
        "step_ms": t_step, "samples_per_s": BATCH * BLOCK / (t_step * 1e-3),
        "step_profile": step_prof,
        f"superstep_{per_launch}_ms": t_super,
        f"superstep_{per_launch}_profile": super_prof,
        "eager_step_ms": t_eager, "eager_step_profile": eager_prof,
        "capture_s": {str(key): c.capture_s for key, c in rx.program.graphs.items()},
        "graph_pool_mb": program.STATS["pool_bytes"] / 2**20,
    }


def profile_loop(dev, iters: int = 10) -> dict:
    """The closed adaptation loop at its defaults for ``iters`` generations,
    unprofiled and under the profiler (after a warm-up run)."""
    adapt_loop(iters=iters, device=dev)
    out = adapt_loop(iters=iters, device=dev)
    prof = _device_profile(lambda: adapt_loop(iters=iters, device=dev))
    return {
        "batch": 64, "iters": iters, "payload_len": 32, "snr_db": 15.0,
        "packets_per_sec": out["packets_per_sec"], "stage_s": out["stage_s"],
        "configs_visited": out["configs_visited"],
        "generation_ms": out["wall_s"] / iters * 1e3,
        "profile": prof,
        "device_kernel_launches_per_generation": prof["device_kernel_launches"] / iters,
        "device_busy_ms_per_generation": prof["device_busy_ms"] / iters,
    }


def fir_formulations(dev, gen) -> dict:
    """``fir.conv_full`` (one conv1d, TF32 off) against one shifted
    multiply-add a tap, on 64 x 65,536 complex samples with the 65-tap
    ``design_lowpass(0.25)``: their times and largest difference."""
    x = torch.complex(torch.randn((BATCH, BLOCK), generator=gen, device=dev),
                      torch.randn((BATCH, BLOCK), generator=gen, device=dev))
    h = resample.design_lowpass(0.25)

    def fma():
        out = torch.zeros((BATCH, BLOCK + len(h) - 1), dtype=torch.complex64, device=dev)
        for j, tap in enumerate(h.tolist()):
            out[:, j : j + BLOCK] += x * tap
        return out

    a, t_conv = _timed(lambda: fir.conv_full(x, h), reps=10)
    b, t_fma = _timed(fma, reps=10)
    return {"shape": [BATCH, BLOCK], "taps": len(h), "conv1d_tf32_off_ms": t_conv,
            "shifted_fma_ms": t_fma, "max_abs_diff": float((a - b).abs().max()),
            "max_abs": float(b.abs().max())}


def dsp_ops(dev, gen, loop_len: int = 8192) -> dict:
    """The rest of ``ops/`` that no receiver path calls, on 64 channels: the
    parallel ones (agc_block, agc_windowed, mix_down, mix_up) at 65,536
    samples, the per-sample loops (agc_scan, pll_track: a few launches a
    sample) at ``loop_len``."""
    rows = lambda n: torch.complex(torch.randn((BATCH, n), generator=gen, device=dev),
                                   torch.randn((BATCH, n), generator=gen, device=dev))
    x, xs, ref = rows(BLOCK), rows(loop_len), rows(loop_len)
    dphi = torch.rand(BATCH, generator=gen, device=dev) * 0.01
    out = {"rows": BATCH, "parallel_len": BLOCK, "loop_len": loop_len}
    for name, fn in (("agc_block", lambda: agc.agc_block(x)),
                     ("agc_windowed", lambda: agc.agc_windowed(x)),
                     ("mix_down", lambda: nco.mix_down(x, dphi, 0.3)),
                     ("mix_up", lambda: nco.mix_up(x, dphi, 0.3))):
        out[f"{name}_ms"] = _timed(fn, reps=10)[1]
    for name, fn, reps in (("agc_scan", lambda: agc.agc_scan(xs), 3),
                           ("pll_track", lambda: nco.pll_track(xs, ref), 3)):
        fn()  # warm-up
        out[f"{name}_ms"] = _timed(fn, reps=reps)[1]
        out[f"{name}_us_per_sample"] = out[f"{name}_ms"] * 1e3 / loop_len
        out[f"{name}_device_launches"] = _device_profile(fn)["device_kernel_launches"]
    return out


def rs_decode_launches(dev, gen) -> dict:
    """Device launches and time of one Reed-Solomon decode of 64 x 36 blocks
    of 67 + 32 bytes (the slots of one (10,0,2) sharded step), 4 byte errors a
    block."""
    from torch.profiler import ProfilerActivity, profile

    n, msg_len = 64 * 36, 67
    msg = torch.randint(0, 256, (n, msg_len), generator=gen, device=dev, dtype=torch.int32)
    code = rs.encode(msg.to(torch.uint8))
    code[:, 5:9] ^= 0x5A
    out, t_ms = _timed(lambda: rs.decode(code, msg_len))
    if not torch.equal(out, msg.to(torch.uint8)):
        raise RuntimeError("Reed-Solomon decode did not return the message")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rs.decode(code, msg_len)
        torch.cuda.synchronize()
    evs = _device_events(prof)
    return {"blocks": n, "block_bytes": msg_len + rs.NROOTS, "decode_ms": t_ms,
            "device_kernel_launches": int(sum(e.count for e in evs)),
            "device_busy_ms": sum(e.device_time_total for e in evs) / 1e3}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sharded", action="store_true",
                    help="also profile the time-sharded receiver and one Reed-Solomon decode")
    ap.add_argument("--flexrx", action="store_true",
                    help="also profile FlexRx on a mixed-config block and an SFO block")
    ap.add_argument("--stream", action="store_true",
                    help="also profile StreamingRx and the closed adaptation loop")
    ap.add_argument("--resampled", action="store_true",
                    help="also profile the resampled receiver step and the FIR formulations")
    ap.add_argument("--out", type=Path, default=None, help="directory for profile_step.json")
    args = ap.parse_args()
    dev = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    cases = ((FrameConfig(1, 0, 0, 64), 20.0), (FrameConfig(1, 1, 1, 64), 10.0))
    report = {"card": card, "torch": torch.__version__,
              "configs": [profile_config(c, snr, dev, gen) for c, snr in cases]}
    if args.sharded:
        report["sharded"] = [profile_config(c, snr, dev, gen, sharded=True) for c, snr in cases]
        report["rs_decode"] = rs_decode_launches(dev, gen)
    if args.flexrx:
        report["flexrx"] = profile_flexrx(dev)
        report["sfo"] = profile_config(FrameConfig(8, 0, 0, 1200), 28.0, dev, gen, ppm=50.0)
    if args.stream:
        report["stream"] = [profile_stream(c, snr, dev, gen) for c, snr in cases]
        report["loop"] = profile_loop(dev)
    if args.resampled:
        report["resampled"] = [profile_config(c, snr, dev, gen, resampled=True) for c, snr in cases]
        report["fir"] = fir_formulations(dev, gen)
        report["dsp_ops"] = dsp_ops(dev, gen)
    print(json.dumps(report, indent=1))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "profile_step.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
