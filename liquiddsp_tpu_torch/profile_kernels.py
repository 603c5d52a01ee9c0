"""Where the time of the Viterbi and recover kernels goes on the GPU.

    python3 -m liquiddsp_tpu_torch.profile_kernels [--sass DIR]

Prints, with the card's name and power limit, for the Viterbi kernel at
several frame counts (132 frames are one warp an SM: the bare dependent
chain; 960 are the receiver's) its time by CUDA events and, from the kernel's
own ``clock64()`` stamps, the cycles a trellis step takes in the forward pass
and in the traceback; for the recover kernel at the receiver's two shapes its
time and a block's cycles in the derotation and in the filter, and at one
candidate of 4 symbols, which is the least the timing method can read. Times
are taken twice: after a flush that WRITES 512 MB (as ``chip_smoke.py`` does:
the L2 is then full of dirty lines, whose write-back competes with the
kernel) and after one that READS 512 MB (a cold but clean L2).

``--sass DIR`` writes the disassembly of the library's kernels there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.kernels.recover import recover_symbols_planes, recover_tile
from liquiddsp_tpu_torch.kernels.viterbi import viterbi

VITERBI_STEPS = 1086
VITERBI_FRAMES = (132, 528, 960, 1056)
RECOVER_SHAPES = ((64, 35, 512), (64, 15, 1330), (1, 1, 4))  # rows, candidates a row, symbols


def _time_ms(fn, flush: torch.Tensor, dirty: bool, iters: int = 20) -> float:
    """Median by CUDA events, the L2 flushed (and the card kept busy) before
    every timed call, by a write or by a read of ``flush``."""
    fn()
    times = []
    for _ in range(iters):
        if dirty:
            flush.zero_()
        else:
            flush.view(torch.int64).max()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _phases(stamps: torch.Tensor) -> list[float]:
    return (stamps[:, 1:] - stamps[:, :-1]).to(torch.float64).median(dim=0).values.tolist()


def measure(dev, flush) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {"viterbi": [], "recover": []}
    for b in VITERBI_FRAMES:
        lam = torch.randn((b, VITERBI_STEPS, 2), generator=gen, device=dev)
        lam[:, ::7] = 0.0  # erasures: ties
        stamps = torch.zeros((b, 3), dtype=torch.int64, device=dev)
        viterbi(lam, stamps=stamps)
        torch.cuda.synchronize()
        fwd, back = _phases(stamps)
        out["viterbi"].append({
            "frames": b, "steps": VITERBI_STEPS,
            "ms": _time_ms(lambda: viterbi(lam), flush, True),
            "ms_clean_l2": _time_ms(lambda: viterbi(lam), flush, False),
            "forward_cycles_per_step": fwd / VITERBI_STEPS,
            "traceback_cycles_per_step": back / VITERBI_STEPS})
    for b, k, n_syms in RECOVER_SHAPES:
        n = 2 * n_syms + 28
        u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
        args = (torch.randn((b, k, n), generator=gen, device=dev),
                torch.randn((b, k, n), generator=gen, device=dev),
                u(b, k) * 0.1 - 0.05, u(b, k) * 6.28 - 3.14, u(b, k) + 0.5,
                torch.randn((b, k, 30), generator=gen, device=dev), n_syms)
        stamps = torch.zeros((b * k * recover_tile(n_syms)[1], 3), dtype=torch.int64, device=dev)
        recover_symbols_planes(*args, stamps=stamps)
        torch.cuda.synchronize()
        derot, filt = _phases(stamps)
        out["recover"].append({
            "planes": [b, k, n], "n_syms": n_syms,
            "ms": _time_ms(lambda: recover_symbols_planes(*args), flush, True),
            "ms_clean_l2": _time_ms(lambda: recover_symbols_planes(*args), flush, False),
            "derotate_cycles_per_block": derot, "filter_cycles_per_block": filt})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", type=Path, default=None, help="directory for the kernels' disassembly")
    args = ap.parse_args()
    dev = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    flush = torch.zeros(512 << 20, dtype=torch.uint8, device=dev)
    _cuda.lib()
    ptxas = [line.strip() for chunk in _cuda.build_log for line in chunk.splitlines()
             if chunk.startswith(("== viterbi", "== recover")) and ("registers" in line or "spill" in line)]
    print(json.dumps({"card": card, "ptxas": ptxas, **measure(dev, flush)}, indent=1))
    if args.sass is not None:
        args.sass.mkdir(parents=True, exist_ok=True)
        dump = subprocess.run([_cuda.toolkit_exe("cuobjdump"), "-sass", str(_cuda.build())],
                              capture_output=True, text=True)
        (args.sass / "kernels.sass").write_text(dump.stdout + dump.stderr)


if __name__ == "__main__":
    main()
