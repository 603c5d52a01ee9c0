"""Loopback demo: flex_tx -> AWGN channel -> flex_rx, printing link metrics.

Counterpart of ``apps/loopback_demo.py`` on this package: the QPSK loopback
of BASELINE config 1 at a chosen SNR, with recovery statistics. It runs on
the GPU, and on the CPU with ``--cpu``:

    python -m liquiddsp_tpu_torch.apps.loopback_demo [--cpu] --snr 20 --packets 8 --mod 1
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.phy.frame_spec import FrameSpec
from liquiddsp_tpu_torch.runtime.blocks import FlexRx
from liquiddsp_tpu_torch.utils.metrics import MetricsCollector


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mod", type=int, default=1, help="modulation index 0-10")
    ap.add_argument("--inner", type=int, default=0, help="inner FEC index 0-6")
    ap.add_argument("--outer", type=int, default=0, help="outer FEC index 0-7")
    ap.add_argument("--snr", type=float, default=20.0, help="SNR in dB")
    ap.add_argument("--cfo", type=float, default=0.0, help="CFO rad/sample")
    ap.add_argument("--packets", type=int, default=10)
    ap.add_argument("--payload-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument(
        "--native-io",
        action="store_true",
        help="stream all packets through the native C++ ring-buffer runtime "
        "(one continuous stream chunked by a producer thread) instead of "
        "per-packet arrays",
    )
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    cfg = FrameConfig(args.mod, args.inner, args.outer, args.payload_len)
    rng = np.random.default_rng(args.seed)
    collector = MetricsCollector()

    n_ok = 0
    if args.native_io:
        n_ok = _run_native_io(args, cfg, rng, collector, dev)
    else:
        rx = FlexRx(max_payload_len=args.payload_len, device=dev)
        for _ in range(args.packets):
            payload = rng.integers(0, 256, (1, args.payload_len), dtype=np.uint8)
            frame = framegen.framegen(torch.from_numpy(payload), cfg, device=dev).cpu().numpy()
            t = frame.shape[1] + 2048
            x = np.zeros((1, t), dtype=np.complex64)
            off = int(rng.integers(100, 1000))
            x[0, off : off + frame.shape[1]] = frame
            x *= np.exp(1j * args.cfo * np.arange(t))[None, :]
            p_sig = np.mean(np.abs(frame) ** 2)
            sigma = np.sqrt(p_sig / (2 * 10 ** (args.snr / 10)))
            x = (x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
            infos = rx.work(x)
            collector.samples += t
            for info in infos:
                collector.count_packet(
                    info["modulation"], info["inner_code"], info["outer_code"],
                    bool(info["payload_valid"]),
                )
                if info["payload_valid"] and np.array_equal(np.asarray(info["payload"]), payload[0]):
                    n_ok += 1

    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    print(f"packets sent: {args.packets}")
    if args.native_io:
        print("io path: native C++ ring-buffer runtime (threaded source)")
    print(f"payloads recovered bit-exactly: {n_ok}")
    print(f"config counters (received/correct): "
          f"{int(collector.num_received.sum())}/{int(collector.num_correct.sum())}")
    rep = collector.report()
    print(f"processed {rep['samples']} samples in {rep['elapsed_s']:.2f}s "
          f"({rep['samples_per_sec']:.0f} samp/s host-loop rate)")
    return {"packets": args.packets, "recovered": n_ok}


def _run_native_io(args, cfg, rng, collector, dev) -> int:
    """TX all packets into one continuous stream, push it through the native
    C++ ring-buffer runtime (producer thread -> chunked reads), and decode
    with the stateful StreamingRx: the streaming path end to end."""
    from liquiddsp_tpu_torch.runtime.native import NativeChunkSource
    from liquiddsp_tpu_torch.runtime.stream import StreamingRx

    f = FrameSpec(cfg).frame_samples
    gap = 600
    payloads = rng.integers(0, 256, (args.packets, args.payload_len), dtype=np.uint8)
    frames = framegen.framegen(torch.from_numpy(payloads), cfg, device=dev).cpu().numpy()
    chunk = max(4096, 2 * f)
    # a whole number of chunks: the source stops at EOF once less than one
    # chunk remains, and the last frame ends only gap + 256 samples before
    # the stream's end
    t = args.packets * (f + gap) + 512
    t = -(-t // chunk) * chunk
    x = np.zeros(t, dtype=np.complex64)
    for i in range(args.packets):
        off = 256 + i * (f + gap)
        x[off : off + f] = frames[i]
    x = x * np.exp(1j * args.cfo * np.arange(t)).astype(np.complex64)
    p_sig = np.mean(np.abs(frames) ** 2)
    sigma = np.sqrt(p_sig / (2 * 10 ** (args.snr / 10)))
    x = (x + sigma * (rng.standard_normal(t) + 1j * rng.standard_normal(t))).astype(np.complex64)

    rx = StreamingRx(cfg, batch=1, chunk_len=chunk, device=dev)
    src = NativeChunkSource(x, chunk_len=chunk, overlap=0)
    want = {bytes(p) for p in payloads}
    n_ok = 0
    try:
        for c in src.chunks():
            res = rx.step(torch.from_numpy(c[None, :]))
            ok = res.payload_valid[0].cpu().numpy()
            fields = {k: getattr(res, k)[0].cpu().numpy()
                      for k in ("modulation", "inner_code", "outer_code", "payload")}
            for k in np.nonzero(ok)[0]:
                collector.count_packet(int(fields["modulation"][k]), int(fields["inner_code"][k]),
                                       int(fields["outer_code"][k]), True)
                if bytes(fields["payload"][k]) in want:
                    n_ok += 1
            collector.samples += chunk
    finally:
        src.stop()
    return n_ok


if __name__ == "__main__":
    main()
