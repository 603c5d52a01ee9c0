"""The halo kernel alone on the card, at the block of one rank of two and at
the one-card shape.

    python3 -m liquiddsp_tpu_torch.profile_halo

Shapes: a rank's block of the sharded stream across two processes, x
[8, 262144] in 4 shards, launched as rank 0 launches it (no rank to its
left: no push) and as rank 1 (its head pushed into a second buffer, its
last tail zeroed, and, where the package has it, the flag that the push
stores); and the whole stream on one card, x [8, 524288] in 8 shards. Both
overlaps of the sharded path: 1051 (QPSK uncoded) and 2687 (QPSK + V27 +
Golay). Beside them, as a yardstick of how fast the card copies that many
bytes, PyTorch's ``copy_`` of x into a tensor of its shape. Each line is the
median of 50 calls timed by CUDA events, the 50 MB L2 cache flushed before
each, beside the byte bound at 3.35 TB/s.

To compare two trees in one call, run this file with the other tree's
package first on the path:

    PYTHONPATH=<other tree> python3 <this tree>/liquiddsp_tpu_torch/profile_halo.py
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from liquiddsp_tpu_torch.kernels import halo

PEAK_BYTES_PER_S = 3.35e12
REPS = 50


def _median_ms(fn, flush: torch.Tensor) -> float:
    fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {card}; halo kernel from {halo.__file__}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    flags = torch.zeros(2, dtype=torch.int64, device=dev)
    signals = hasattr(halo, "halo_order")
    for b, t, n_time in ((8, 262144, 4), (8, 524288, 8)):
        x = torch.complex(torch.randn((b, t), generator=gen, device=dev),
                          torch.randn((b, t), generator=gen, device=dev))
        t_local = t // n_time
        y = torch.empty_like(x)
        ms = _median_ms(lambda: y.copy_(x), flush)
        bound = 2 * x.numel() * 8 / PEAK_BYTES_PER_S * 1e3
        print(json.dumps({"case": "torch copy_ of x", "x": [b, t], "ms": ms, "bound_ms": bound,
                          "share": bound / ms, "card": card}))
        for ov in (1051, 2687):
            win, left = (torch.empty((n_time, b, t_local + ov), dtype=torch.complex64, device=dev)
                         for _ in range(2))
            nbytes = b * t * 8 + n_time * b * (t_local + ov) * 8
            cases = {"one card": lambda: halo.halo_windows_into(x, n_time, ov, win, None, True)}
            if n_time == 4:
                cases = {
                    "rank 0": lambda: halo.halo_windows_into(x, n_time, ov, win, None, False),
                    "rank 1": lambda: halo.halo_windows_into(x, n_time, ov, win, left, True),
                }
                if signals:
                    cases["rank 1 with its flag"] = lambda: halo.halo_windows_into(
                        x, n_time, ov, win, left, True, flags[0], 1, flags[1])
            for name, fn in cases.items():
                ms = _median_ms(fn, flush)
                bound = nbytes / PEAK_BYTES_PER_S * 1e3
                print(json.dumps({"case": name, "x": [b, t], "n_time": n_time, "ov": ov, "ms": ms,
                                  "bound_ms": bound, "share": bound / ms, "card": card}))


if __name__ == "__main__":
    main()
