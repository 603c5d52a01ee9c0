#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (liquiddsp_tpu_torch).

Run it from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit; exits non-zero without a card.
2. build: compiles liquiddsp_tpu_torch/csrc/*.cu with nvcc (set-up time).
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the block receiver gives it, then timed with CUDA events
   beside the plain version, the bound of the card and, for the correlator,
   one library call (a complex torch.matmul on the block-Toeplitz form).
4. main path: for both receiver configs (QPSK uncoded; QPSK + V27 + Golay),
   framegen 64 payloads, lay out a 64 x 65,536 stream with AWGN, decode it
   with framesync_fixed, and hold every payload against what was sent. The
   kernels' launch counters are set to 0 just before and read just after.
   Two rows are decoded again on the CPU through the plain versions and must
   give the same frames.

The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device: this script needs one GPU", file=sys.stderr)
    sys.exit(1)

from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.kernels.correlator import (
    correlate_reduced,
    correlate_reduced_ref,
)
from liquiddsp_tpu_torch.kernels.extract import extract_windows, extract_windows_ref
from liquiddsp_tpu_torch.kernels.recover import (
    recover_symbols_planes,
    recover_symbols_planes_ref,
)
from liquiddsp_tpu_torch.kernels.viterbi import viterbi, viterbi_ref
from liquiddsp_tpu_torch.ops.fec import conv
from liquiddsp_tpu_torch.phy import detector
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.framesync import framesync_fixed
from liquiddsp_tpu_torch.phy.tables import phy_tables
from liquiddsp_tpu_torch.streams import tiled_stream

BATCH, BLOCK = 64, 65536
CONFIGS = (  # (config, SNR dB, least share of frames that must decode)
    (FrameConfig(1, 0, 0, 64), 20.0, 1.0),
    (FrameConfig(1, 1, 1, 64), 10.0, 0.99),
)
# published peaks of one H100 SXM at its full power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
DEV = torch.device("cuda", 0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


_flush = None


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median time of ``fn`` in ms by CUDA events, the 50 MB L2 flushed
    before every timed call."""
    global _flush
    if _flush is None:
        _flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, then timed
# ---------------------------------------------------------------------------


def toeplitz_operands(x: torch.Tensor, templates: np.ndarray):
    """Block-Toeplitz form of the correlator for the library yardstick:
    [B*NB, 2L] complex signal blocks and the [2L, F*L] template matrix."""
    f, l = templates.shape
    m = np.zeros((2 * l, f, l), dtype=np.complex64)
    for fi in range(f):
        cs = np.conj(templates[fi])
        for o in range(l):
            m[o:l, fi, o] = cs[: l - o]
            m[l : l + o, fi, o] = cs[l - o :]
    b, t = x.shape
    nb = -(-t // l)
    xp = torch.nn.functional.pad(x, (0, (nb + 1) * l - t)).reshape(b, nb + 1, l)
    xcat = torch.cat([xp[:, :nb], xp[:, 1:]], dim=-1).reshape(b * nb, 2 * l).contiguous()
    return xcat, torch.from_numpy(m.reshape(2 * l, f * l)).to(x.device)


def check_correlator(x: torch.Tensor) -> dict:
    tm = detector.templates_time()
    got = correlate_reduced(x, tm)
    torch.cuda.synchronize()
    ref = correlate_reduced_ref(x, tm)
    err = float(torch.max(torch.abs(got["rho2"] - ref["rho2"])))
    if not err <= 1e-5:  # f32 sums of 128 terms in another order
        fail(f"correlator rho2 differs from the plain version by {err}")
    if not torch.allclose(got["energy"], ref["energy"], rtol=1e-3, atol=1e-2):
        fail("correlator energy differs from the plain version")
    peaks = ref["rho2"] > 0.04
    if not bool(peaks.any()):
        fail("correlator check found no peaks")
    if not torch.equal(got["fbin"][peaks], ref["fbin"][peaks]):
        fail("correlator arg-max bins differ at peaks")
    if not torch.allclose(got["corr"][peaks], ref["corr"][peaks], rtol=1e-4, atol=1e-4):
        fail("correlator peak correlations differ")
    # library yardstick: cross-check its surface once, then time it
    xcat, mt = toeplitz_operands(x, tm)
    surf = (xcat[:128] @ mt).reshape(128, 5, 128)  # first 128 blocks of row 0
    mag = (surf.real**2 + surf.imag**2).amax(dim=1).reshape(-1)
    mine = got["rho2"][0, : 128 * 128] * got["energy"][0, : 128 * 128].clamp(min=1e-12)
    es = float(np.sum(np.abs(tm[0]) ** 2))
    if not torch.allclose(mag / es, mine, rtol=1e-3, atol=1e-3):
        fail("library yardstick does not compute the correlator's function")
    b, t = x.shape
    nbytes = b * t * 8 + tm.size * 8 + b * t * (4 + 4 + 8 + 4)
    # 5 x 128 complex multiply-adds per lag; the energy is a sliding sum
    # (one sample in, one out: about 4 operations a lag), which the energy
    # tolerance above admits, so a direct 128-term sum is not charged
    flops = b * t * (128 * 5 * 8 + 4)
    bms, by = bound(nbytes, flops)
    return {
        "name": "correlator", "route": "cuda",
        "source": "liquiddsp_tpu_torch/csrc/correlator.cu",
        "replaces": "liquiddsp_tpu/kernels/correlator.py:147",
        "max_abs_err": err,
        "ms": time_ms(lambda: correlate_reduced(x, tm), 10),
        "plain_ms": time_ms(lambda: correlate_reduced_ref(x, tm), 3, 1),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(lambda: xcat @ mt, 5, 1),
        "shapes": f"x [{b}, {t}] c64, templates [5, 128] c64",
    }


def check_extract(x: torch.Tensor, cases) -> dict:
    entry = None
    for starts, n in cases:
        gr, gi = extract_windows(x, starts, n, return_planes=True)
        torch.cuda.synchronize()
        rr, ri = extract_windows_ref(x, starts, n)
        err = max(float((gr - rr).abs().max()), float((gi - ri).abs().max()))
        if err != 0.0 or not (torch.equal(gr, rr) and torch.equal(gi, ri)):
            fail(f"extract differs from the plain version at n={n} by {err}")
        b, k = starts.shape
        # the function must read each window sample and write it once
        bms, by = bound(b * k * 4 + 2 * b * k * n * 8, 0)
        t = {
            "ms": time_ms(lambda: extract_windows(x, starts, n, return_planes=True), 10),
            "plain_ms": time_ms(lambda: extract_windows_ref(x, starts, n), 5),
            "bound_ms": bms, "bound_by": by,
            "shapes": f"x [{x.shape[0]}, {x.shape[1]}] c64, starts [{b}, {k}], n={n}",
        }
        if entry is None:
            entry = {
                "name": "extract", "route": "cuda",
                "source": "liquiddsp_tpu_torch/csrc/extract.cu",
                "replaces": "liquiddsp_tpu/kernels/extract.py:96",
                "max_abs_err": err, **t, "library_ms": None,
            }
        else:
            entry["coded_config"] = t
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return entry


def check_recover(x: torch.Tensor, cases, gen: torch.Generator) -> dict:
    entry = None
    bank = phy_tables(None, DEV).timing_bank30
    for starts, n_syms in cases:
        b, k = starts.shape
        n = fs.K_SAMP * n_syms + fs.PULSE_TAIL
        wr, wi = extract_windows(x, starts, n, return_planes=True)
        u = lambda lo, hi: torch.rand((b, k), generator=gen, device=DEV) * (hi - lo) + lo
        dphi, phi, gamma = u(-0.05, 0.05), u(-np.pi, np.pi), u(0.5, 2.0)
        taps = bank[torch.randint(0, 33, (b, k), generator=gen, device=DEV)].contiguous()
        args = (wr, wi, dphi, phi, gamma, taps, n_syms)
        got = recover_symbols_planes(*args)
        torch.cuda.synchronize()
        ref = recover_symbols_planes_ref(*args)
        scale = float(torch.max(torch.abs(ref)))
        err = float(torch.max(torch.abs(got - ref)))
        # f32 phase dphi*m + phi at |phase| up to ~150 rad, and 30-term sums
        if not err <= 2e-4 * scale:
            fail(f"recover differs from the plain version by {err} (scale {scale})")
        c = b * k
        nbytes = c * n * 8 + c * (3 * 4 + 30 * 4) + c * n_syms * 8
        flops = c * n * 12 + c * n_syms * 120  # phase, sin, cos, derotation; filter
        bms, by = bound(nbytes, flops)
        t = {
            "ms": time_ms(lambda: recover_symbols_planes(*args), 10),
            "plain_ms": time_ms(lambda: recover_symbols_planes_ref(*args), 5),
            "bound_ms": bms, "bound_by": by,
            "shapes": f"planes [{b}, {k}, {n}] f32 -> [{b}, {k}, {n_syms}] c64",
        }
        if entry is None:
            entry = {
                "name": "recover", "route": "cuda",
                "source": "liquiddsp_tpu_torch/csrc/recover.cu",
                "replaces": "liquiddsp_tpu/kernels/recover.py:115",
                "max_abs_err": err, **t, "library_ms": None,
            }
        else:
            entry["coded_config"] = t
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return entry


def check_viterbi(gen: torch.Generator) -> dict:
    b, nbits = 64 * 15, 1080
    steps = nbits + conv.NTAIL
    msg = torch.randint(0, 2, (b, nbits), generator=gen, device=DEV, dtype=torch.int32)
    coded = conv.encode(msg.to(torch.int8), 1).to(torch.float32)
    lam = 1.0 - 2.0 * coded
    lam[: b // 2] += 0.9 * torch.randn((b // 2, 2 * steps), generator=gen, device=DEV)
    lam[-8:] = 0.0  # all erasures: every add-compare-select ties
    lam[-16:-8, ::3] = 0.0  # erasures mixed into hard decisions
    lam = lam.reshape(b, steps, 2).contiguous()
    got = viterbi(lam)
    torch.cuda.synchronize()
    ref = viterbi_ref(lam)
    n_diff = int((got != ref).sum())  # bits that differ: the error of a bit-exact kernel
    if n_diff != 0:
        fail(f"viterbi differs from the plain version in {n_diff} bits")
    if not torch.equal(got[b // 2 : -16, :nbits].to(torch.int32), msg[b // 2 : -16]):
        fail("viterbi does not return the message on noiseless input")
    # a long punctured trellis (payload 256 + Golay + V27P78): erasures at
    # every punctured slot, several chunks of the kernel's staging loop
    nlong = 4160
    msg_l = torch.randint(0, 2, (32, nlong), generator=gen, device=DEV, dtype=torch.int32)
    llr_l = 1.0 - 2.0 * conv.encode(msg_l.to(torch.int8), 6).to(torch.float32)
    llr_l += 0.3 * torch.randn(llr_l.shape, generator=gen, device=DEV)
    full = torch.zeros((32, 2 * (nlong + conv.NTAIL)), device=DEV)
    full.index_copy_(1, conv._keep_idx(nlong + conv.NTAIL, 6, DEV), llr_l)
    lam_l = full.reshape(32, nlong + conv.NTAIL, 2)
    n_diff += int((viterbi(lam_l) != viterbi_ref(lam_l)).sum())
    if n_diff != 0:
        fail(f"viterbi differs from the plain version in {n_diff} bits of a 4166-step punctured trellis")
    nbytes = b * steps * 8 + 64 * 16 + b * steps
    # per state and step: 4 adds (two candidates), compare, select, the max
    # over the states and its subtraction. The kernel is bound by the latency
    # of the dependent steps, far from this count.
    flops = b * steps * 64 * 8
    bms, by = bound(nbytes, flops)
    return {
        "name": "viterbi", "route": "cuda",
        "source": "liquiddsp_tpu_torch/csrc/viterbi.cu",
        "replaces": "liquiddsp_tpu/kernels/viterbi.py:195",
        "max_abs_err": float(n_diff),
        "ms": time_ms(lambda: viterbi(lam), 10),
        "plain_ms": time_ms(lambda: viterbi_ref(lam), 2, 1),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "shapes": f"lam [{b}, {steps}, 2] f32 -> bits [{b}, {steps}] i8",
    }


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def config_name(cfg) -> str:
    return f"({cfg.modulation},{cfg.inner_code},{cfg.outer_code})"


def check_frames(res, payloads, n_frames: int, min_share: float, cfg) -> tuple[int, int]:
    spec = fs.FrameSpec(cfg)
    k = res.mask.shape[1]
    if res.payload.shape != (BATCH, k, cfg.payload_len) or res.payload.dtype != torch.uint8:
        fail(f"payload has shape {tuple(res.payload.shape)} {res.payload.dtype}")
    if res.symbols.shape != (BATCH, k, spec.frame_syms):
        fail(f"symbols have shape {tuple(res.symbols.shape)}")
    if not bool(torch.isfinite(torch.view_as_real(res.symbols)).all()):
        fail("symbols are not finite")
    valid = res.payload_valid
    exact = (res.payload == payloads[:, None, :]).all(dim=-1) & valid
    n_ok, n_exact, expected = int(valid.sum()), int(exact.sum()), n_frames * BATCH
    if n_exact != n_ok:
        fail(f"{n_ok - n_exact} valid payloads differ from what was sent")
    if n_ok < min_share * expected or n_ok > expected:
        fail(f"decoded {n_ok} of {expected} frames, need at least {min_share:.0%}")
    return n_ok, expected


def check_against_cpu(x, res, cfg, max_frames: int) -> None:
    """Rows 0-1 decoded on the CPU through the plain versions must give the
    same frames as the GPU run."""
    ref = framesync_fixed(x[:2].cpu(), cfg, max_frames, device="cpu")
    for name in ("mask", "start", "header_valid", "payload_valid"):
        if not torch.equal(getattr(ref, name), getattr(res, name)[:2].cpu()):
            fail(f"GPU and CPU runs disagree on {name} ({cfg})")
    pv = ref.payload_valid
    if not torch.equal(ref.payload[pv], res.payload[:2].cpu()[pv]):
        fail(f"GPU and CPU runs disagree on payload bytes ({cfg})")
    m = ref.mask
    d = torch.max(torch.abs(ref.symbols[m] - res.symbols[:2].cpu()[m]))
    s = torch.max(torch.abs(ref.symbols[m]))
    if not float(d) <= 2e-3 * float(s):  # f32 sums in another order through the chain
        fail(f"GPU and CPU symbols differ by {float(d)} (scale {float(s)})")


def main() -> None:
    t_start = time.perf_counter()
    card = card_line()
    print(f"device: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _cuda.lib()
    print(f"build: {len(_cuda.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s (set-up)")
    for chunk in _cuda.build_log:
        for line in chunk.splitlines():
            if "registers" in line or "==" in line or "spill" in line:
                print("  " + line.strip())

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    streams = [tiled_stream(cfg, snr, BATCH, BLOCK, gen) for cfg, snr, _ in CONFIGS]
    torch.cuda.synchronize()

    # kernel shapes of the main path: the candidates the detector finds
    x_a, x_b = streams[0][0], streams[1][0]
    det_a = detector.detect(x_a, streams[0][3], fine=False)
    det_b = detector.detect(x_b, streams[1][3], fine=False)
    starts_a, starts_b = det_a.start.clone(), det_b.start.clone()
    starts_a[0, -1] = BLOCK - 50  # a window that runs past the end of the row
    spec_a, spec_b = fs.FrameSpec(CONFIGS[0][0]), fs.FrameSpec(CONFIGS[1][0])
    kernels = [
        check_correlator(x_a),
        check_extract(x_a, [(starts_a, spec_a.frame_samples), (starts_b, spec_b.frame_samples)]),
        check_recover(x_a, [(starts_a, spec_a.frame_syms), (starts_b, spec_b.frame_syms)], gen),
        check_viterbi(gen),
    ]
    print(f"kernels: all four agree with their plain versions ({time.perf_counter() - t_start:.0f} s)")

    # each config's step carries its own counts: set to 0 just before, read
    # just after. One step launches the correlator, extract and recover once
    # each, and the Viterbi kernel once where the config has the inner code.
    results, launches = [], []
    for (cfg, _, _), (x, _, _, max_frames) in zip(CONFIGS, streams):
        _cuda.reset_launches()
        results.append(framesync_fixed(x, cfg, max_frames))
        torch.cuda.synchronize()
        got = dict(_cuda.LAUNCHES)
        want = {"correlator": 1, "extract": 1, "recover": 1,
                "viterbi": 1 if cfg.inner_code else 0}
        if got != want:
            fail(f"config {config_name(cfg)} launched {got}, expected {want}")
        launches.append(got)
    for k in kernels:
        k["launches"] = sum(d[k["name"]] for d in launches)
        k["launches_by_config"] = {
            config_name(cfg): d[k["name"]] for (cfg, _, _), d in zip(CONFIGS, launches)
        }
        if k["launches"] < 1:
            fail(f"the main path never launched the {k['name']} kernel")

    for (cfg, snr, share), (x, payloads, n_frames, max_frames), res in zip(
        CONFIGS, streams, results
    ):
        n_ok, expected = check_frames(res, payloads, n_frames, share, cfg)
        check_against_cpu(x, res, cfg, max_frames)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            framesync_fixed(x, cfg, max_frames)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step = float(np.median(times))
        print(
            f"main path: config {config_name(cfg)} "
            f"payload {cfg.payload_len} at {snr:g} dB: {n_ok}/{expected} frames bit-exact, "
            f"step {step * 1e3:.2f} ms, {BATCH * BLOCK / step:.4g} samples/s [{card}]"
        )
    for (cfg, _, _), d in zip(CONFIGS, launches):
        print(f"launches on the main path, one step of config {config_name(cfg)}: {d}")
    print(f"total {time.perf_counter() - t_start:.0f} s")

    print(f"device: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
