#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (liquiddsp_tpu_torch).

Run it from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py [--kernels-only]

With ``--kernels-only`` it stops after phase 3 and prints the kernels' line
only: the quick check after a change to a kernel.

Phases, each fatal on failure:

1. device: the card's name and power limit; exits non-zero without a card.
2. build: compiles liquiddsp_tpu_torch/csrc/*.cu with nvcc (set-up time).
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes that EVERY path below gives it (block, sharded, streaming
   and config-class windows, with the candidates the detector finds there)
   and at the edges of each kernel's design (correlator: one lag, a row
   shorter than the template, a length that fills no whole block, one row, a
   preamble in the last 127 samples, five equal templates; Viterbi: one frame, a frame
   count that fills no whole block, trellises shorter than and no multiple of
   the layout's period, ties in every row; recover: odd symbol counts, odd
   window lengths, one candidate, one symbol, one symbol more than a tile),
   then timed at the block and sharded shapes with CUDA events beside the
   plain version, the bound of the card and, where one PyTorch call computes
   the same function, that call (correlator: a complex torch.matmul on the
   block-Toeplitz form, in float32 and again with TF32 allowed; halo: pad +
   unfold made contiguous). The correlator's SASS must hold tensor-core
   instructions; its bound is that of its three bf16 products on the tensor
   cores, with the float32 CUDA-core bound beside it. The halo kernel's
   cross-process half at a P11 rank's block: the launch that stores the
   left rank's flag once its push has landed (windows, push, flag and block
   count exact), and halo_order, the wait kernel of a step's order, against
   its plain version and holding its stream until another stream stores
   its flag.
4. main path: for both receiver configs (QPSK uncoded; QPSK + V27 + Golay),
   framegen 64 payloads, lay out a 64 x 65,536 stream with AWGN, decode it
   with framesync_fixed, and hold every payload against what was sent. The
   kernels' launch counters are set to 0 just before and read just after.
   Two rows are decoded again on the CPU through the plain versions and must
   give the same frames.
5. sharded path: the same 4.19 M samples a step as 8 channels x 524,288,
   cut into 8 time shards of 65,536 on the one card, through
   sharded_framesync for both configs: every whole frame of the stream
   exactly once, at its true start +-1, with the payload that was sent;
   frames across shard boundaries counted; LinkMetrics against the host's
   count; launches of one step demanded exactly.
6. streaming: ShardedStreamingRx over three consecutive chunks of 8 x 524,288
   of one stream: every whole frame exactly once, those across super-block
   edges included; launches of every step demanded exactly.
7. config classes: differential DQPSK and QAM64 + Reed-Solomon at 30 dB
   through framesync_fixed at 8 x 65,536 and through sharded_framesync at
   2 x 131,072 in 4 shards, each held against the payloads sent and against
   a CPU run through the plain versions; launches of each step demanded
   exactly.
8. (P1) config space at payload 32: all 616 configs, 2 frames each, up to 8
   configs a block, through config_space_loopback and FlexRx (the static
   path, kernels 1-4), on the samples of the reference's recorded run
   (bench/CONFIG_SPACE.json: seed 0 in 8 shards, so 80 blocks): 616/616
   decode bit-exactly against what was sent.
9. (P2) long frames at payload 256: the 56 BPSK configs, 2 frames each, on
   the sample-clock-drift (SFO) path with an 8560-symbol buffer and
   trellises of about 4,160 steps, on the samples of
   bench/CONFIG_SPACE_LONG.json's run (4 shards): 56/56.
10. (P3) SFO at full width: 64 x 65,536 samples of QAM16 frames of 2650
   symbols at 28 dB, rows stretched by +50 and -50 ppm in turn, through
   framesync_fixed with track_sfo="auto" (at least 99 % decode) and False
   (strictly fewer), both without the payload carrier tracker (track=False:
   it slips on some QAM16 payloads whatever the symbol recovery did).
11. (P4) the self-describing receiver at full width: 64 channels x 65,536
   samples, a different config on each channel (drawn from the 490 outside
   the reference-defect class, covering every modulation, inner and outer
   code), 12 frames a channel at payload 64, through FlexRx at
   max_payload_len 64 (the SFO path for every frame) and again with
   expected_configs: the same infos, at least 99 % of the 768 frames, no
   false CRC pass, two channels equal to a CPU run, step time.
12. (P5) the continuous streaming receiver at the reference bench's
   streaming shape: for both receiver configs, 64 channels x 10 chunks of
   65,536 (a payload a frame) through StreamingRx with the bench's slot count:
   run (every whole frame at most once, at least the block path's share,
   bit-exact), superstep of 5 chunks and push in 4,093-sample pieces + flush
   and native ingest (NativeChunkSource, channels interleaved) identical to
   run by start; run_adaptive with the default provisioning on the stream
   tiled 3 times (the frame set of run; the settled bucket printed), again
   from the settled bucket, and on a burst stream (back-to-back frames in
   chunk 7: at least one group decoded again, the frame set of run).
   StreamingRx, FlexRx, FlexTx and FrameDetectorCC replay CUDA graphs on the
   card (core/program.py), here and in every later phase; a capture that
   fails raises and fails the run.
12b. (P13) the program layer at full width, each graph against the eager
   body it captured (called directly, only to compare): for both receiver
   configs on P5's stream, step, superstep of 5, run and run_adaptive equal
   the eager step body bit for bit in every field (run_adaptive's chunks at
   the slot count each was decoded at); eager and graph ms a chunk in
   turns, the host's CUDA API calls and the device-busy share of a step and
   a superstep (torch.profiler), captures, seconds a key and the graph
   pool's memory. P4's block and one P6 loop generation through FlexRx: the
   front end's graph and every payload group's graph equal their eager
   bodies bit for bit, timed in turns; FlexTx and FrameDetectorCC twice
   each against their bodies. Launches of the graph steps demanded exactly.
13. (P6) the closed adaptation loop at bench/adapt_loop.py's defaults (64
   channels, payload 32, 15 dB, 50 generations, epsilon_greedy), pipelined
   (twice: the same decisions) and unpipelined: packets/s, stage split,
   configs visited; payload_exact == payload_valid; a CPU engine fed the
   recorded feedback decides alike in every generation.
14. (P7) the loop on the engine's dynamic noise schedule (nonstationary, 40
   generations, unpipelined, twice), with P6's checks.
15. (P8) the resampled receiver at the reference bench's shape (bench.py
   bench_resampled, BASELINE config 3): for both receiver configs, 64
   channels x 65,536 in four sample-clock groups of 16 (-50, -20, +20, +50
   ppm), resampled by arbitrary_groups with bf16 planes at rank 4, then
   framesync_fixed; frames ending 64 samples or more before the block's end
   are expected. Every valid payload bit-exact, uncoded at least the
   expected count, coded at least 99 %; the resampler held against its CPU
   run (bf16; float32 with TF32 off; float64) and timed three ways; rows 0-1
   of the resampled block decoded again on the CPU give the same frames.
16. (P9) slip_retry: 64 coded QPSK frames whose payload fades in one
   32-symbol segment and comes out of the fade rotated by a quarter turn
   (streams.fade_slip_symbols) through decode_payload_symbols: all recovered
   with slip_retry, none without, both equal to a CPU run; one Viterbi
   launch over the 192 candidates.
17. (P10) the flowgraph layer: the package's grc/graphs/loopback.yaml (8
   packets, 8/8 bit-exact against the source) and adaptation_loop.yaml (50
   packets; the engine's decisions equal a CPU engine's fed the recorded
   packet infos), every block on the card; packets/s.
18. (P11) the sharded receiver across processes: the sharded shape (8 x
   524,288 in 8 time shards, both configs) on two processes of four shards
   each on the one card (apps/sharded_rx_demo's worker, gloo for setup and
   the metrics; every rank joins by the JAX form of init_distributed,
   coordinator="127.0.0.1:<port>", num_processes, process_id, and builds
   make_mesh() of no extents, which must be (2, 1)), the halo kernel pushing each rank's head into the left
   rank's window through CUDA IPC, each step ordered by flags on the card
   (halo_order, no host barrier): every rank's windows equal
   halo_windows_ref of the whole stream exactly, the gathered slots equal the
   one-process run by start, every frame bit-exact and exactly once (those
   across the process boundary counted), the all-reduced LinkMetrics equal
   one process's, and on the (2, 1) grid LinkMetrics.psum(mesh, "time")
   equal to the sum of every rank's own metrics and psum(mesh, "ch") equal
   to the rank's own; three chunks of ShardedStreamingRx on the two processes
   give the one-process frame set. The compute mode, the stream memory
   operations attribute and the order's mechanism; the halo kernel's time on
   each rank with both launching together and with each alone, a step's push
   + wait by CUDA events, and the step on two processes against one.
19. (P12) the demos on the card: apps/adaptation_demo for 50 packets (a CPU
   engine fed its feedback decides alike) and apps/supervised_rx_demo with
   two workers on the card, one killed once (12/12 frames exactly once,
   restarts=[1, 0]).

Every step of every path is driven with the kernels' launch counters set to 0
just before and read just after (a graph replay adds the launches its
capture recorded; the warm-up before a capture is counted apart), and fails unless each kernel of that path
was launched exactly as often as the path demands: once a block (a
streaming window, a loop generation, a flowgraph packet) for the correlator
and extract, once a block on the static path for recover (never on the SFO
path), once a config group with an inner code for the Viterbi kernel (the
speculative groups of P4 counted; in the loop, between the speculative
groups and those plus the decoded header groups; once for P9's three
candidates of every frame), once a sharded step for halo; in P11 each rank
once a step, counted in the rank's own process, and halo_wait (the order's
wait kernel, checked in phase 3 with the halo kernel's flag) once a step
before the halo kernel and once after it on a rank with a rank to its
right.

The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import random
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device: this script needs one GPU", file=sys.stderr)
    sys.exit(1)

from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch import config_space as cs
from liquiddsp_tpu_torch.core import program
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.kernels.correlator import (
    correlate_reduced,
    correlate_reduced_ref,
)
from liquiddsp_tpu_torch.kernels.extract import extract_windows, extract_windows_ref
from liquiddsp_tpu_torch.kernels.halo import (
    halo_order,
    halo_order_ref,
    halo_windows,
    halo_windows_into,
    halo_windows_ref,
)
from liquiddsp_tpu_torch.kernels.recover import (
    recover_symbols_planes,
    recover_symbols_planes_ref,
    recover_tile,
)
from liquiddsp_tpu_torch.kernels.viterbi import viterbi, viterbi_ref
from liquiddsp_tpu_torch.grc.loader import GRAPHS_DIR, Flowgraph
from liquiddsp_tpu_torch.ops.fec import conv, registry
from liquiddsp_tpu_torch.ops.resample import arbitrary_groups, lowrank_operands, plane_conv
from liquiddsp_tpu_torch.parallel.halo import sharded_framesync
from liquiddsp_tpu_torch.parallel.mesh import make_mesh
from liquiddsp_tpu_torch.phy import detector
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.framesync import (
    SFO_AUTO_SYMS,
    decode_payload_symbols,
    framesync_fixed,
)
from liquiddsp_tpu_torch.phy.tables import phy_tables
from liquiddsp_tpu_torch.adapt_loop import adapt_loop, block_samples, channel_block
from liquiddsp_tpu_torch.apps import adaptation_demo
from liquiddsp_tpu_torch.apps.sharded_rx_demo import Job, spawn_ranks
from liquiddsp_tpu_torch.engine.cognitive_engine import CognitiveEngineBlock
from liquiddsp_tpu_torch.runtime import blocks
from liquiddsp_tpu_torch.runtime.blocks import FlexRx, FlexTx, FrameDetectorCC
from liquiddsp_tpu_torch.runtime.sim import ChannelModel
from liquiddsp_tpu_torch.runtime.distributed_stream import ShardedStreamingRx
from liquiddsp_tpu_torch.runtime.native import NativeChunkSource
from liquiddsp_tpu_torch.runtime.stream import StreamingRx, split_results
from liquiddsp_tpu_torch.streams import (
    RESAMPLED_PPMS,
    RESAMPLED_TAIL_MARGIN,
    burst_stream,
    fade_slip_symbols,
    long_stream,
    resampled_stream,
    shard_slots,
    stretched_stream,
    tiled_stream,
)
from liquiddsp_tpu_torch.utils.metrics import LinkMetrics

BATCH, BLOCK = 64, 65536
CONFIGS = (  # (config, SNR dB, least share of frames that must decode)
    (FrameConfig(1, 0, 0, 64), 20.0, 1.0),
    (FrameConfig(1, 1, 1, 64), 10.0, 0.99),
)
# the sharded path: the same samples a step as long channels, 8 time shards
SH_BATCH, SH_TOTAL, SH_NTIME = 8, 524288, 8
# config classes beyond QPSK, at a smaller depth: (config, SNR dB)
CLASS_CONFIGS = ((FrameConfig(5, 0, 0, 64), 30.0), (FrameConfig(10, 0, 2, 64), 30.0))
CL_BATCH, CL_SH_BATCH, CL_SH_TOTAL, CL_SH_NTIME = 8, 2, 131072, 4
# P1-P2: the config-space sweeps (payload, modulations, blocks)
P1_PAYLOAD, P2_PAYLOAD = 32, 256
# P3: long QAM16 frames stretched by +-50 ppm
P3_CFG, P3_SNR, P3_PPM = FrameConfig(8, 0, 0, 1200), 28.0, 50.0
# P4: one config a channel at payload 64 (12 frames a channel)
P4_PAYLOAD, P4_SEED = 64, 7
# P5: the reference bench's streaming shape (bench.py bench_streaming):
# 64 channels, chunks of 65,536, 10 chunks; run_adaptive on it tiled 3 times
P5_CHUNKS, P5_PER_LAUNCH, P5_TILES, P5_PUSH = 10, 5, 3, 4093
# P6-P7: bench/adapt_loop.py's defaults; P7 its dynamic schedule
P6_ITERS, P6_SNR, P6_PAYLOAD, P7_ITERS = 50, 15.0, 32, 40
# P9: slip_retry on 64 faded and slipped frames of the coded config
P9_CFG, P9_FRAMES, P9_NOISE_VAR = FrameConfig(1, 1, 1, 64), 64, 0.01
# P10: packets through the port's two flowgraphs
P10_LOOPBACK, P10_ADAPT = 8, 50
# P11: the sharded shape over a (2, 1) grid of processes on the card; P12:
# the adaptation demo's packets
P11_RANKS, P11_SEED, P11_REPS, P11_TIMEOUT_S = (2, 1), 11, 5, 600.0
P12_PACKETS = 50
# published peaks of one H100 SXM at its full power limit: memory, float32
# on CUDA cores, dense bf16 on tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# the correlator runs three bf16 products (hi x hi, hi x lo, lo x hi) for one
# float32 product
SPLIT_PRODUCTS = 3
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
    before every timed call. The flush writes 512 MB (about 0.2 ms of device
    time), so the card is still busy when the host has queued ``fn``: the
    events then bracket the kernels and not the host's time to launch them."""
    global _flush
    if _flush is None:
        _flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEV)
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


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` of memory traffic and ``flops``
    operations at the rate ``peak``, and which of the two sets it."""
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3
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


def compare_correlator(x: torch.Tensor, tm: np.ndarray | None = None, peaks_needed: bool = True):
    """The correlator kernel against its plain version on ``x`` (with the
    detector's templates unless ``tm`` is given). Returns the largest
    difference of rho2 and the kernel's outputs."""
    tm = detector.templates_time() if tm is None else tm
    got = correlate_reduced(x, tm)
    torch.cuda.synchronize()
    ref = correlate_reduced_ref(x, tm)
    shape = f"x [{x.shape[0]}, {x.shape[1]}]"
    err = float(torch.max(torch.abs(got["rho2"] - ref["rho2"])))
    # the kernel's three bf16 products carry 16 significant bits of each
    # operand, and its sums run in another order
    if not err <= 1e-5:
        fail(f"correlator rho2 differs from the plain version by {err} at {shape}")
    if not torch.allclose(got["energy"], ref["energy"], rtol=1e-3, atol=1e-2):
        fail(f"correlator energy differs from the plain version at {shape}")
    peaks = ref["rho2"] > 0.04
    if not bool(peaks.any()):
        if not peaks_needed:
            return err, got
        fail(f"correlator check found no peaks at {shape}")
    if not torch.equal(got["fbin"][peaks], ref["fbin"][peaks]):
        fail(f"correlator arg-max bins differ at peaks at {shape}")
    if not torch.allclose(got["corr"][peaks], ref["corr"][peaks], rtol=1e-4, atol=1e-4):
        fail(f"correlator peak correlations differ at {shape}")
    return err, got


def correlator_edge_x(b: int, t: int, hits, gen: torch.Generator) -> torch.Tensor:
    """[b, t] unit noise with preambles added: ``hits`` (row, start, bin)
    puts template ``bin`` at ``start`` of ``row``, cut at the row's end."""
    tm = torch.from_numpy(detector.templates_time()).to(DEV)
    x = torch.complex(torch.randn((b, t), generator=gen, device=DEV),
                      torch.randn((b, t), generator=gen, device=DEV)) * (0.5**0.5)
    for r, s, f in hits:
        n = min(128, t - s)
        x[r, s : s + n] += 5.0 * tm[f, :n]
    return x.contiguous()


def check_correlator_edges(gen: torch.Generator) -> tuple[float, list[str]]:
    """The correlator against its plain version at the edges of its tiling
    (512 lags a block, 64 a warp, 8 a tile, 640 samples staged): one lag; a
    row shorter than the template; a length that fills no whole block, tile
    or warp; one row; a preamble in the last 127 samples of a row (its window
    runs past the end); five equal templates (bin 0 everywhere)."""
    err, done = 0.0, []
    cases = (
        ("T = 1", correlator_edge_x(3, 1, (), gen), False),
        ("T = 100", correlator_edge_x(2, 100, ((0, 0, 0), (1, 10, 4)), gen), True),
        ("T = 1001", correlator_edge_x(4, 1001, ((0, 3, 2), (2, 511, 1), (3, 600, 3)), gen), True),
        ("B = 1", correlator_edge_x(1, 4099, ((0, 1000, 4), (0, 3000, 0)), gen), True),
        ("preamble in the last 127 samples",
         correlator_edge_x(2, 2048, ((0, 2048 - 120, 0), (1, 2048 - 64, 2)), gen), True),
    )
    for label, x, peaks in cases:
        err = max(err, compare_correlator(x, peaks_needed=peaks)[0])
        done.append(f"edge {label}: x [{x.shape[0]}, {x.shape[1]}]")
        if label.startswith("preamble"):
            ref = correlate_reduced_ref(x, detector.templates_time())
            if not bool((ref["rho2"][:, -127:] > 0.04).any()):
                fail("correlator edge: no peak in the last 127 lags")
    x = correlator_edge_x(8, 65536, ((r, 1000 + 7919 * r, r % 5) for r in range(8)), gen)
    same = np.repeat(detector.templates_time()[:1], 5, axis=0)
    e, got = compare_correlator(x, same)
    if not bool((got["fbin"] == 0).all()):
        fail("correlator: five equal templates give a bin other than 0")
    done.append("edge five equal templates: x [8, 65536], fbin 0 everywhere")
    return max(err, e), done


def correlator_build_facts() -> dict:
    """The correlator's registers and shared memory (``-Xptxas -v``) and its
    SASS: the count of tensor-core (HMMA) and float32 fused multiply-add
    (FFMA) instructions. Fails without HMMA: the products must run on the
    tensor cores."""
    ptxas = [line.strip() for chunk in _cuda.build_log if chunk.startswith("== correlator.cu")
             for line in chunk.splitlines() if "registers" in line or "spill" in line]
    dump = subprocess.run([_cuda.toolkit_exe("cuobjdump"), "-sass", str(_cuda.build())],
                          capture_output=True, text=True, timeout=300)
    funcs = [f for f in dump.stdout.split("Function : ")[1:] if "correlate_kernel" in f.splitlines()[0]]
    if len(funcs) != 1:
        fail(f"correlator: {len(funcs)} SASS functions named correlate_kernel")
    ops = re.findall(r"\b(HMMA|HGMMA|FFMA)\b", funcs[0])
    sass = {op: ops.count(op) for op in ("HMMA", "HGMMA", "FFMA")}
    if sass["HMMA"] + sass["HGMMA"] == 0:
        fail(f"correlator: no tensor-core instruction in its SASS ({sass})")
    return {"ptxas": ptxas, "sass": sass}


def check_correlator(x: torch.Tensor, gen: torch.Generator) -> dict:
    tm = detector.templates_time()
    err, got = compare_correlator(x)
    edge_err, edges = check_correlator_edges(gen)
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
    # the kernel's bound: three bf16 products on the tensor cores; beside it
    # the float32 CUDA-core bound of the earlier design, for comparison
    bms, by = bound(nbytes, SPLIT_PRODUCTS * flops, PEAK_BF16_FLOPS)
    bms_cc, by_cc = bound(nbytes, flops)
    library_ms = time_ms(lambda: xcat @ mt, 5, 1)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        library_tf32_ms = time_ms(lambda: xcat @ mt, 5, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return {
        "name": "correlator", "route": "cuda",
        "source": "liquiddsp_tpu_torch/csrc/correlator.cu",
        "replaces": "liquiddsp_tpu/kernels/correlator.py:147",
        "max_abs_err": max(err, edge_err),
        "ms": time_ms(lambda: correlate_reduced(x, tm), 10),
        "plain_ms": time_ms(lambda: correlate_reduced_ref(x, tm), 3, 1),
        "bound_ms": bms, "bound_by": by,
        "bound_note": f"{SPLIT_PRODUCTS} bf16 products at {PEAK_BF16_FLOPS:.3g} flop/s",
        "bound_ms_cuda_cores": bms_cc, "bound_by_cuda_cores": by_cc,
        "library_ms": library_ms,
        "library_tf32_ms": library_tf32_ms,
        "library_tf32_note": "the same product with TF32 allowed: less precise than the kernel",
        "shapes": f"x [{b}, {t}] c64, templates [5, 128] c64",
        "also_checked": edges,
        **correlator_build_facts(),
    }


def compare_extract(x: torch.Tensor, starts: torch.Tensor, n: int) -> float:
    """The extract kernel against its plain version: exact."""
    gr, gi = extract_windows(x, starts, n, return_planes=True)
    torch.cuda.synchronize()
    rr, ri = extract_windows_ref(x, starts, n)
    err = max(float((gr - rr).abs().max()), float((gi - ri).abs().max()))
    if err != 0.0 or not (torch.equal(gr, rr) and torch.equal(gi, ri)):
        fail(f"extract differs from the plain version at x {tuple(x.shape)}, n={n} by {err}")
    return err


def extract_library(x: torch.Tensor, starts: torch.Tensor, n: int):
    """The same windows as one PyTorch gather: every length-n window of the
    zero-padded row, indexed at the starts."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return torch.nn.functional.pad(x, (n, n)).unfold(-1, n, 1)[rows, starts.to(torch.int64) + n]


def check_extract(x: torch.Tensor, cases) -> dict:
    entry = None
    for starts, n in cases:
        err = compare_extract(x, starts, n)
        b, k = starts.shape
        if not torch.equal(extract_library(x, starts, n), extract_windows(x, starts, n)):
            fail("library yardstick does not compute the extract kernel's function")
        # the function must read each window sample and write it once
        bms, by = bound(b * k * 4 + 2 * b * k * n * 8, 0)
        t = {
            "ms": time_ms(lambda: extract_windows(x, starts, n, return_planes=True), 10),
            "plain_ms": time_ms(lambda: extract_windows_ref(x, starts, n), 5),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: extract_library(x, starts, n), 5),
            "shapes": f"x [{x.shape[0]}, {x.shape[1]}] c64, starts [{b}, {k}], n={n}",
        }
        if entry is None:
            entry = {
                "name": "extract", "route": "cuda",
                "source": "liquiddsp_tpu_torch/csrc/extract.cu",
                "replaces": "liquiddsp_tpu/kernels/extract.py:96",
                "max_abs_err": err, **t,
            }
        else:
            entry["coded_config"] = t
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return entry


def compare_recover(x: torch.Tensor, starts: torch.Tensor, n_syms: int, gen: torch.Generator,
                    extra: int = 0):
    """The recover kernel against its plain version on the windows of ``x``
    at ``starts`` (``extra`` samples longer than the symbols need) with random
    carrier, gain and timing taps. Returns the largest difference and the
    arguments."""
    b, k = starts.shape
    n = fs.K_SAMP * n_syms + fs.PULSE_TAIL + extra
    bank = phy_tables(None, DEV).timing_bank30
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
        fail(f"recover differs from the plain version at planes [{b}, {k}, {n}] by {err} (scale {scale})")
    return err, args


# edges of the recover kernel's design: (rows, candidates a row, n_syms, extra
# samples a window). Odd n_syms: rows on both 8-byte phases; an odd window
# length: rows on all 4-byte phases; one candidate; one symbol; one symbol more
# than the largest tile holds (two blocks, the last not a whole quad); the
# longest frame (4426 samples)
RECOVER_EDGES = ((3, 5, 513, 0), (4, 3, 1331, 0), (1, 1, 512, 0), (2, 3, 1, 0),
                 (3, 2, 445, 1), (2, 2, 2199, 0))


def recover_stamps(args) -> dict:
    """Where a block's time goes, by the kernel's own clock64() stamps:
    the derotation (loads, sincosf, phasor steps) against the filter."""
    wr, n_syms = args[0], args[-1]
    blocks = recover_tile(n_syms)[1]
    stamps = torch.zeros((wr.shape[0] * wr.shape[1] * blocks, 3), dtype=torch.int64, device=DEV)
    recover_symbols_planes(*args, stamps=stamps)
    torch.cuda.synchronize()
    d = (stamps[:, 1:] - stamps[:, :-1]).to(torch.float64).median(dim=0).values
    return {"derotate_cycles_per_block": float(d[0]), "filter_cycles_per_block": float(d[1])}


def check_recover(x: torch.Tensor, cases, gen: torch.Generator) -> dict:
    edge_err = 0.0
    for b, k, n_syms, extra in RECOVER_EDGES:
        n = fs.K_SAMP * n_syms + fs.PULSE_TAIL + extra
        starts = torch.randint(0, x.shape[1] - n, (b, k), generator=gen, device=DEV, dtype=torch.int32)
        edge_err = max(edge_err, compare_recover(x[:b], starts, n_syms, gen, extra)[0])
    entry = None
    for starts, n_syms in cases:
        b, k = starts.shape
        n = fs.K_SAMP * n_syms + fs.PULSE_TAIL
        err, args = compare_recover(x, starts, n_syms, gen)
        c = b * k
        nbytes = c * n * 8 + c * (3 * 4 + 30 * 4) + c * n_syms * 8
        flops = c * n * 12 + c * n_syms * 120  # phase, sin, cos, derotation; filter
        bms, by = bound(nbytes, flops)
        t = {
            "ms": time_ms(lambda: recover_symbols_planes(*args), 10),
            "plain_ms": time_ms(lambda: recover_symbols_planes_ref(*args), 5),
            "bound_ms": bms, "bound_by": by,
            "shapes": f"planes [{b}, {k}, {n}] f32 -> [{b}, {k}, {n_syms}] c64",
            **recover_stamps(args),
        }
        if entry is None:
            entry = {
                "name": "recover", "route": "cuda",
                "source": "liquiddsp_tpu_torch/csrc/recover.cu",
                "replaces": "liquiddsp_tpu/kernels/recover.py:115",
                "max_abs_err": max(err, edge_err), **t, "library_ms": None,
                "also_checked": [
                    f"edge: planes [{b}, {k}, {fs.K_SAMP * ns + fs.PULSE_TAIL + extra}], {ns} syms"
                    for b, k, ns, extra in RECOVER_EDGES],
            }
        else:
            entry["coded_config"] = t
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return entry


# edges of the Viterbi kernel's design: (frames, trellis steps). One frame;
# a frame count that is no multiple of the warps a block holds; trellises
# shorter than, and no multiple of, the layout's period of 5 steps, the
# traceback's block of 30 and the 160 steps staged at a time
VITERBI_EDGES = ((1, 1086), (961, 37), (3, 7), (961, 193), (2, 161))


def viterbi_edge_lam(b: int, steps: int, gen: torch.Generator) -> torch.Tensor:
    """lam [b, steps, 2] with ties in every row: rows in turn noisy with every
    fifth value erased, hard decisions with every third erased, all erased."""
    msg = torch.randint(0, 2, (b, steps - conv.NTAIL), generator=gen, device=DEV, dtype=torch.int32)
    lam = 1.0 - 2.0 * conv.encode(msg.to(torch.int8), 1).to(torch.float32)
    kind = (torch.arange(b, device=DEV) % 3)[:, None]
    col = torch.arange(2 * steps, device=DEV)[None, :]
    lam = lam + torch.where(kind == 0, 0.9, 0.0) * torch.randn(lam.shape, generator=gen, device=DEV)
    erased = ((kind == 0) & (col % 5 == 0)) | ((kind == 1) & (col % 3 == 0)) | (kind == 2)
    return torch.where(erased, 0.0, lam).reshape(b, steps, 2).contiguous()


def check_viterbi(gen: torch.Generator) -> dict:
    for eb, esteps in VITERBI_EDGES:
        lam_e = viterbi_edge_lam(eb, esteps, gen)
        got_e = viterbi(lam_e)
        torch.cuda.synchronize()
        n_diff = int((got_e != viterbi_ref(lam_e)).sum())
        if n_diff != 0:
            fail(f"viterbi differs from the plain version in {n_diff} bits at lam [{eb}, {esteps}, 2]")
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
    # every punctured slot, 27 chunks of the kernel's staging loop
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
    # where a frame's time goes, by the kernel's own clock64() stamps
    stamps = torch.zeros((b, 3), dtype=torch.int64, device=DEV)
    viterbi(lam, stamps=stamps)
    torch.cuda.synchronize()
    cyc = (stamps[:, 1:] - stamps[:, :-1]).to(torch.float64).median(dim=0).values / steps
    ms = time_ms(lambda: viterbi(lam), 10)
    return {
        "name": "viterbi", "route": "cuda",
        "source": "liquiddsp_tpu_torch/csrc/viterbi.cu",
        "replaces": "liquiddsp_tpu/kernels/viterbi.py:195",
        "max_abs_err": float(n_diff),
        "ms": ms, "ns_per_step": ms * 1e6 / steps,
        "forward_cycles_per_step": float(cyc[0]), "traceback_cycles_per_step": float(cyc[1]),
        "plain_ms": time_ms(lambda: viterbi_ref(lam), 2, 1),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "shapes": f"lam [{b}, {steps}, 2] f32 -> bits [{b}, {steps}] i8",
        "also_checked": [f"edge: lam [{eb}, {es}, 2]" for eb, es in VITERBI_EDGES]
        + ["lam [32, 4166, 2], rate 7/8 punctured"],
    }


def check_halo(x: torch.Tensor, n_time: int, ovs, also, gen: torch.Generator) -> dict:
    """The halo kernel against its plain version: exact. ``x`` at the sharded
    path's shape with the overlap of each config, the streams ``also`` (x,
    n_time, ov) of the streaming and config-class paths, then one awkward
    shape."""
    b3, tl3, nt3 = 3, 4097, 5  # odd shard length: windows and tails on odd samples
    odd = torch.complex(
        torch.randn((b3, nt3 * tl3), generator=gen, device=DEV),
        torch.randn((b3, nt3 * tl3), generator=gen, device=DEV),
    )
    err = 0.0
    for xx, nt, ov in [(x, n_time, ov) for ov in ovs] + also + [(odd, nt3, ovs[0]), (odd, nt3, 0), (odd, 1, tl3)]:
        got = halo_windows(xx, nt, ov)
        torch.cuda.synchronize()
        ref = halo_windows_ref(xx, nt, ov)
        if got.shape != ref.shape or not torch.equal(got, ref):
            fail(f"halo differs from the plain version at x {tuple(xx.shape)}, n_time={nt}, ov={ov}")
        err = max(err, float(torch.view_as_real(got - ref).abs().max()))
    b, t = x.shape
    t_local = t // n_time
    entry = None
    for ov in ovs:
        w = t_local + ov
        lib = lambda: torch.nn.functional.pad(x, (0, ov)).unfold(-1, w, t_local).contiguous()
        if not torch.equal(lib().transpose(0, 1), halo_windows(x, n_time, ov)):
            fail("library yardstick does not compute the halo kernel's function")
        # one read of x, one write of the windows
        bms, by = bound(b * t * 8 + n_time * b * w * 8, 0)
        tm = {
            "ms": time_ms(lambda: halo_windows(x, n_time, ov), 10),
            "plain_ms": time_ms(lambda: halo_windows_ref(x, n_time, ov), 5),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lib, 5),
            "shapes": f"x [{b}, {t}] c64, n_time={n_time}, ov={ov} -> [{n_time}, {b}, {w}] c64",
        }
        if entry is None:
            entry = {
                "name": "halo", "route": "cuda",
                "source": "liquiddsp_tpu_torch/csrc/halo.cu",
                "replaces": "liquiddsp_tpu/parallel/halo.py:110",
                "max_abs_err": err, **tm,
                "also_checked": [
                    f"x [{xx.shape[0]}, {xx.shape[1]}], n_time={nt}, ov={ov}" for xx, nt, ov in also],
            }
        else:
            entry["coded_config"] = tm
    return entry


def check_halo_order(x: torch.Tensor, n_time: int, ov: int) -> tuple[dict, str]:
    """The halo kernel's cross-process half on one card. (1) The halo kernel
    that stores a flag once its push has landed, at ``x``, the block of a
    P11 rank with a left rank and the global last shard: its windows equal
    the plain version, its push the head, the flag its value and the block
    count 0 again. (2) halo_order, the receive semaphore's wait: a store and
    a wait that holds against halo_order_ref (exact), and a wait that does
    not hold yet holding its stream until another stream stores the flag.
    Returns the wait kernel's entry and what (1) checked."""
    b, t = x.shape
    t_local = t // n_time
    win = torch.empty((n_time, b, t_local + ov), dtype=torch.complex64, device=DEV)
    left = torch.zeros_like(win)
    flags = torch.zeros(4, dtype=torch.int64, device=DEV)
    halo_windows_into(x, n_time, ov, win, left, True, flags[0], 7, flags[1])
    torch.cuda.synchronize()
    if not torch.equal(win, halo_windows_ref(x, n_time, ov)):
        fail("the halo kernel with a flag differs from the plain version")
    if not torch.equal(left[n_time - 1, :, t_local:], x[:, :ov]):
        fail("the halo kernel with a flag pushed another head into the left window")
    if flags[:2].tolist() != [7, 0]:
        fail(f"the halo kernel left its flag and block count at {flags[:2].tolist()}, not [7, 0]")
    flags.zero_()
    flags[2] = 3
    ref = flags.cpu()
    halo_order(flags[0], 5, flags[2], 3)
    halo_order_ref(ref[0], 5, ref[2], 3)
    err = float((flags.cpu() - ref).abs().max())
    if err != 0:
        fail(f"halo_order stored {flags.tolist()}, the plain version {ref.tolist()}")
    waiter, storer = torch.cuda.Stream(DEV), torch.cuda.Stream(DEV)
    done = torch.cuda.Event()
    with torch.cuda.stream(waiter):
        halo_order(None, 0, flags[3], 1)
        done.record()
    time.sleep(0.05)
    if done.query():
        fail("halo_order let its stream go on before its flag held")
    with torch.cuda.stream(storer):
        halo_order(flags[3], 1, None, 0)
    deadline = time.monotonic() + 10.0
    while not done.query():
        if time.monotonic() > deadline:
            fail("halo_order still holds its stream 10 s after its flag was stored")
        time.sleep(1e-3)
    bms, by = bound(16, 0)  # one flag read, one written
    entry = {
        "name": "halo_wait", "route": "cuda",
        "source": "liquiddsp_tpu_torch/csrc/halo.cu",
        "replaces": "liquiddsp_tpu/parallel/halo.py:110",
        "max_abs_err": err,
        "ms": time_ms(lambda: halo_order(flags[0], 5, flags[2], 3), 10),
        "plain_ms": time_ms(lambda: halo_order_ref(flags[0], 5, flags[2], 3), 10),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "shapes": "two int64 flags: a store, then a wait that holds at once",
        "note": "the receive-semaphore wait of _halo_dma_kernel (rdr.wait(), "
                "liquiddsp_tpu/parallel/halo.py:84): one thread, st.release.sys, then "
                "ld.acquire.sys and __nanosleep until the flag holds",
    }
    return entry, (f"with its flag: x [{b}, {t}], n_time={n_time}, ov={ov}, pushed into a "
                   f"second buffer")


def check_path_shapes(kernels, label, x, n_syms: int, k: int, gen: torch.Generator,
                      recover: bool = True) -> None:
    """Kernels 1-3 against their plain versions at the shapes one more path
    gives them: ``x`` is the [rows, samples] tensor that path's receiver
    sees, the candidates are the ``k`` a row that the detector finds there,
    the windows those of an ``n_syms`` symbol buffer. ``recover=False`` for
    the sample-clock-drift path, which reads complex windows and does not run
    the recover kernel. Not timed."""
    n = fs.K_SAMP * n_syms + fs.PULSE_TAIL
    errs = {"correlator": compare_correlator(x)[0]}
    starts = detector.detect(x, k, fine=False).start
    errs["extract"] = compare_extract(x, starts, n)
    if recover:
        errs["recover"] = compare_recover(x, starts, n_syms, gen)[0]
    for entry in kernels:
        if entry["name"] in errs:
            entry["max_abs_err"] = max(entry["max_abs_err"], errs[entry["name"]])
            entry.setdefault("also_checked", []).append(
                f"{label}: x [{x.shape[0]}, {x.shape[1]}], {k} slots a row, "
                f"n={n}" + (f", {n_syms} syms" if recover else ""))


def receiver_lam(frames: int, payload_len: int, inner: int, outer: int,
                 gen: torch.Generator) -> torch.Tensor:
    """lam [frames, steps, 2] as decode_payload_symbols hands it to the Viterbi
    kernel for a config: the coded bits of random messages of that payload's
    outer-coded length, punctured by the inner code, with noise, then
    depunctured (zeros at the punctured slots)."""
    nbits = registry.outer_encoded_bits(payload_len + 3, outer)
    msg = torch.randint(0, 2, (frames, nbits), generator=gen, device=DEV, dtype=torch.int32)
    llr = 1.0 - 2.0 * conv.encode(msg.to(torch.int8), inner).to(torch.float32)
    llr += 0.5 * torch.randn(llr.shape, generator=gen, device=DEV)
    steps = nbits + conv.NTAIL
    full = torch.zeros((frames, 2 * steps), device=DEV)
    full.index_copy_(1, conv._keep_idx(steps, inner, DEV), llr)
    return full.reshape(frames, steps, 2)


def check_viterbi_lam(kernels, label, lam: torch.Tensor) -> None:
    """The Viterbi kernel against its plain version (bit-exact) at ``lam``."""
    got = viterbi(lam)
    torch.cuda.synchronize()
    n_diff = int((got != viterbi_ref(lam)).sum())
    if n_diff:
        fail(f"viterbi differs from the plain version in {n_diff} bits at {label} lam {list(lam.shape)}")
    entry = next(e for e in kernels if e["name"] == "viterbi")
    entry.setdefault("also_checked", []).append(f"{label}: lam {list(lam.shape)}")


def check_viterbi_shapes(kernels, label, frames: int, payload_len: int, gen) -> None:
    """The Viterbi kernel against its plain version (bit-exact) at the
    trellises a receiver path gives it: every outer code's message length at
    this payload, each with another of the six inner codes' punctures."""
    shapes = []
    for outer in range(8):
        inner = 1 + outer % 6
        lam = receiver_lam(frames, payload_len, inner, outer, gen)
        got = viterbi(lam)
        torch.cuda.synchronize()
        n_diff = int((got != viterbi_ref(lam)).sum())
        if n_diff:
            fail(f"viterbi differs from the plain version in {n_diff} bits at {label} "
                 f"lam {list(lam.shape)} (inner {inner}, outer {outer})")
        shapes.append(lam.shape[1])
    entry = next(e for e in kernels if e["name"] == "viterbi")
    entry.setdefault("also_checked", []).append(
        f"{label}: lam [{frames}, steps, 2], steps {sorted(set(shapes))}, every puncture")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def config_name(cfg) -> str:
    return f"({cfg.modulation},{cfg.inner_code},{cfg.outer_code})"


def check_frames(res, payloads, n_frames: int, min_share: float, cfg,
                 most: int | None = None) -> tuple[int, int]:
    """Every valid payload bit-exact, and at least ``min_share`` of the
    ``n_frames`` a row expected, at most ``most`` in all (the expected count
    when None)."""
    spec = fs.FrameSpec(cfg)
    k = res.mask.shape[1]
    batch = payloads.shape[0]
    if res.payload.shape != (batch, k, cfg.payload_len) or res.payload.dtype != torch.uint8:
        fail(f"payload has shape {tuple(res.payload.shape)} {res.payload.dtype}")
    if res.symbols.shape != (batch, k, spec.frame_syms):
        fail(f"symbols have shape {tuple(res.symbols.shape)}")
    if not bool(torch.isfinite(torch.view_as_real(res.symbols)).all()):
        fail("symbols are not finite")
    valid = res.payload_valid
    exact = (res.payload == payloads[:, None, :]).all(dim=-1) & valid
    n_ok, n_exact, expected = int(valid.sum()), int(exact.sum()), n_frames * batch
    if n_exact != n_ok:
        fail(f"{n_ok - n_exact} valid payloads differ from what was sent")
    if n_ok < min_share * expected or n_ok > (expected if most is None else most):
        fail(f"decoded {n_ok} of {expected} frames, need at least {min_share:.0%}")
    return n_ok, expected


COMPARED = ("mask", "start", "header_valid", "payload_valid", "payload", "symbols")


def by_start(res, rows=slice(None)) -> dict:
    """The compared fields of ``rows`` on the host with every row's slots put
    in the order of their start, detected slots first. The receiver orders
    its slots by correlation score, and at a high SNR the scores of two
    frames differ by less than float32 rounding does between two runs, so
    slot order is no part of the result."""
    f = {n: getattr(res, n)[rows].cpu() for n in COMPARED}
    key = torch.where(f["mask"], f["start"].to(torch.int64), torch.iinfo(torch.int64).max)
    order = torch.sort(key, dim=1, stable=True).indices
    for n, v in f.items():
        idx = order.reshape(order.shape + (1,) * (v.dim() - 2)).expand(v.shape)
        f[n] = torch.gather(v, 1, idx)
    return f


def same_results(what, a: dict, b: dict) -> None:
    """Two runs (``by_start`` dicts) found and decoded the same frames. What
    an undetected slot holds is noise and is not compared."""
    m, pv = a["mask"], a["payload_valid"]
    if not torch.equal(m, b["mask"]) or not torch.equal(a["start"][m], b["start"][m]):
        fail(f"{what}: the two runs disagree on the frames found")
    for name in ("header_valid", "payload_valid"):
        if not torch.equal(a[name], b[name]):
            fail(f"{what}: the two runs disagree on {name}")
    if not torch.equal(a["payload"][pv], b["payload"][pv]):
        fail(f"{what}: the two runs disagree on payload bytes")
    d = float(torch.max(torch.abs(a["symbols"][m] - b["symbols"][m])))
    sc = float(torch.max(torch.abs(a["symbols"][m])))
    if not d <= 2e-3 * sc:  # f32 sums in another order through the chain
        fail(f"{what}: symbols differ by {d} (scale {sc})")


def check_against_cpu(x, res, cfg, max_frames: int) -> None:
    """Rows 0-1 decoded on the CPU through the plain versions must give the
    same frames as the GPU run."""
    ref = framesync_fixed(x[:2].cpu(), cfg, max_frames, device="cpu")
    same_results(f"GPU against CPU ({config_name(cfg)})", by_start(ref),
                 by_start(res, slice(0, 2)))


def block_launches(cfg, halo: int, waits: int = 0) -> dict:
    """What one step of framesync_fixed (``halo`` 0) or sharded_framesync
    (``halo`` 1) launches for frames of ``cfg`` on the static path.
    ``waits``: the launches of halo_order (``halo_wait``) in a step of a
    rank of several (P11): one before its halo kernel, and one after it on
    a rank that has a rank to its right (``rank_waits``)."""
    return {"correlator": 1, "extract": 1, "recover": 1,
            "viterbi": 1 if cfg.inner_code else 0, "halo": halo, "halo_wait": waits}


def rank_waits(rank: int, ranks: tuple[int, int]) -> int:
    """halo_order launches in one step of ``rank`` on a (P_t, P_c) grid:
    none where the time axis is not split over ranks."""
    return 0 if ranks[0] == 1 else 1 + (rank // ranks[1] < ranks[0] - 1)


def counted(what: str, want: dict, step):
    """Drive one step of a path with the kernels' launch counters set to 0
    just before and read just after; fail unless each kernel was launched
    exactly as ``want`` says. Returns (the step's result, the counts)."""
    return counted_by(what, lambda _: want, step)


def counted_by(what: str, want_of, step):
    """``counted`` for a step whose launches follow from what it did:
    ``want_of(result)`` gives the demanded counts, an exact number or an
    inclusive (least, most) range for each kernel."""
    torch.cuda.synchronize()
    _cuda.reset_launches()
    res = step()
    torch.cuda.synchronize()
    got = dict(_cuda.LAUNCHES)
    want = want_of(res)
    ok = got.keys() == want.keys() and all(
        w[0] <= got[k] <= w[1] if isinstance(w, tuple) else got[k] == w for k, w in want.items())
    if not ok:
        fail(f"{what} launched {got}, expected {want}")
    return res, got


# ---------------------------------------------------------------------------
# phases 5-7: the time-sharded receiver
# ---------------------------------------------------------------------------


def check_stream_frames(
    what, valid, start, payload, payloads, starts, whole, min_share, t_local=None, ov=0
) -> tuple[int, int, int]:
    """Hold decoded slots [B, S] (``valid``, absolute ``start``, ``payload``)
    against the stream that ``long_stream`` laid out: every valid slot sits on
    a true frame start +-1 and carries that frame's payload, no frame is
    decoded twice, and at least ``min_share`` of the whole frames are decoded.
    Returns (decoded, whole frames, decoded frames that run across a shard
    boundary of ``t_local``)."""
    dist = (start.to(torch.int64)[:, :, None] - starts[:, None, :]).abs()  # [B, S, n_slots]
    near, idx = dist.min(dim=-1)
    if bool((valid & (near > 1)).any()):
        fail(f"{what}: {int((valid & (near > 1)).sum())} valid frames lie on no true start")
    sent = torch.gather(payloads, 1, idx[:, :, None].expand(-1, -1, payloads.shape[-1]))
    wrong = valid & ~(sent == payload).all(dim=-1)
    if bool(wrong.any()):
        fail(f"{what}: {int(wrong.sum())} valid payloads differ from what was sent")
    times = torch.zeros(starts.shape, dtype=torch.int64, device=starts.device)
    times.scatter_add_(1, idx, valid.to(torch.int64))
    if bool((times > 1).any()):
        fail(f"{what}: {int((times > 1).sum())} frames were decoded more than once")
    n_ok, expected = int(((times == 1) & whole).sum()), int(whole.sum())
    if n_ok < min_share * expected:
        fail(f"{what}: decoded {n_ok} of {expected} whole frames, need at least {min_share:.0%}")
    n_cross = 0
    if t_local is not None:
        cross = whole & (starts % t_local >= t_local - ov) & (times == 1)
        n_cross = int(cross.sum())
        if n_cross == 0:
            fail(f"{what}: no decoded frame runs across a shard boundary")
    return n_ok, expected, n_cross


def check_metrics(what, res, samples: int) -> None:
    """LinkMetrics, summed on the card, against the host's own count."""
    m = LinkMetrics.from_results(res, samples)
    host = res.to_numpy()
    hv = host["header_valid"]
    want = (samples, int(host["mask"].sum()), int(hv.sum()), int(host["payload_valid"].sum()))
    got = (int(m.samples), int(m.frames_detected), int(m.headers_valid), int(m.payloads_valid))
    if got != want:
        fail(f"{what}: LinkMetrics {got} differ from the host's count {want}")
    for name, total in (("evm", m.sum_evm_db), ("rssi", m.sum_rssi_db)):
        ref = float(host[name][hv].astype(np.float64).sum())
        if not abs(float(total) - ref) <= 1e-3 * max(1.0, abs(ref)):  # f32 sum of a few thousand dB values
            fail(f"{what}: LinkMetrics sum of {name} {float(total)} differs from {ref}")


def sharded_step(cfg, snr, share, stream, card) -> dict:
    """Phase 5 for one config on ``stream`` (what ``long_stream`` returned).
    Returns the launch counts of one step."""
    what = f"sharded path {config_name(cfg)}"
    x, payloads, starts, whole = stream
    mesh = make_mesh(n_time=SH_NTIME, n_ch=1, devices=[DEV])
    t_local = SH_TOTAL // SH_NTIME
    ov = fs.FrameSpec(cfg).frame_samples - 1
    k = shard_slots(cfg, t_local)
    res, got = counted(what, block_launches(cfg, 1),
                       lambda: sharded_framesync(x, cfg, mesh, max_frames_per_shard=k))
    if res.mask.shape != (SH_BATCH, SH_NTIME * k):
        fail(f"{what}: slots have shape {tuple(res.mask.shape)}")
    n_ok, expected, n_cross = check_stream_frames(
        what, res.payload_valid, res.start, res.payload, payloads, starts, whole,
        share, t_local, ov)
    check_metrics(what, res, SH_TOTAL)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded_framesync(x, cfg, mesh, max_frames_per_shard=k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step = float(np.median(times))
    print(
        f"{what} payload {cfg.payload_len} at {snr:g} dB, {SH_BATCH} x {SH_TOTAL} in "
        f"{SH_NTIME} shards (local receiver [{SH_BATCH * SH_NTIME}, {t_local + ov}], {k} slots a shard): "
        f"{n_ok}/{expected} whole frames exactly once and bit-exact, {n_cross} of them across a "
        f"shard boundary, LinkMetrics equal the host's count, "
        f"step {step * 1e3:.2f} ms, {SH_BATCH * SH_TOTAL / step:.4g} samples/s [{card}]"
    )
    return got


def streaming_shapes(cfg) -> tuple[int, int]:
    """(window length, slots a shard) of a ShardedStreamingRx step over
    chunks of SH_TOTAL samples: [carry | chunk | pad to a multiple of the
    shards]."""
    real = SH_TOTAL + fs.FrameSpec(cfg).frame_samples - 1
    window = real + (-real) % SH_NTIME
    return window, shard_slots(cfg, window // SH_NTIME)


def streaming_run(cfg, snr, stream, card) -> dict:
    """Phase 6: three consecutive chunks of one stream through
    ShardedStreamingRx. Returns the launch counts of one step."""
    what = f"streaming {config_name(cfg)}"
    x, payloads, starts, whole = stream
    total = x.shape[1]
    n_chunks = total // SH_TOTAL
    mesh = make_mesh(n_time=SH_NTIME, n_ch=1, devices=[DEV])
    ov = fs.FrameSpec(cfg).frame_samples - 1
    window, k = streaming_shapes(cfg)
    rx = ShardedStreamingRx(cfg, mesh, batch=SH_BATCH, chunk_len=SH_TOTAL, max_frames_per_shard=k)
    if rx.window != window:
        fail(f"{what}: the receiver's window is {rx.window} samples, the kernels were checked at {window}")
    valid, start, payload, detected = [], [], [], 0
    for c in range(n_chunks):
        chunk = x[:, c * SH_TOTAL : (c + 1) * SH_TOTAL]
        (res, metrics), got = counted(f"{what}, step {c}", block_launches(cfg, 1),
                                      lambda: rx.step(chunk))
        valid.append(res.payload_valid)
        start.append(res.start.to(torch.int64) + res.epoch)
        payload.append(res.payload)
        detected += int(metrics.payloads_valid)
    valid, start, payload = (torch.cat(v, dim=1) for v in (valid, start, payload))
    n_ok, expected, _ = check_stream_frames(
        what, valid, start, payload, payloads, starts, whole, 1.0)
    if detected != n_ok:
        fail(f"{what}: the steps' LinkMetrics count {detected} valid payloads, the host {n_ok}")
    # frames that run across a super-block edge: decoded from the carry
    f = ov + 1
    edge = whole & (starts % SH_TOTAL > SH_TOTAL - f) & (starts < total - SH_TOTAL)
    if int(edge.sum()) == 0:
        fail(f"{what}: no frame runs across a super-block edge")
    print(
        f"{what} at {snr:g} dB, {n_chunks} chunks of {SH_BATCH} x {SH_TOTAL} "
        f"({total} samples a channel, windows of {window} in {SH_NTIME} shards, {k} slots a shard): "
        f"{n_ok}/{expected} whole frames exactly once and "
        f"bit-exact at start + epoch, {int(edge.sum())} of them across a super-block edge [{card}]"
    )
    return got


def config_class_run(cfg, snr, block_stream, sh_stream, card) -> tuple[dict, dict]:
    """Phase 7 for one config class: the block receiver and the sharded one,
    each against the payloads sent and against the CPU's plain versions.
    Returns the launch counts of the block step and of the sharded step."""
    name = config_name(cfg)
    x, payloads, n_frames, max_frames = block_stream
    res, got_block = counted(
        f"config class {name}, block", block_launches(cfg, 0),
        lambda: framesync_fixed(x, cfg, max_frames))
    n_ok, expected = check_frames(res, payloads, n_frames, 1.0, cfg)
    check_against_cpu(x, res, cfg, max_frames)
    print(
        f"config class {name} payload {cfg.payload_len} at {snr:g} dB, block receiver "
        f"{CL_BATCH} x {BLOCK}: {n_ok}/{expected} frames bit-exact, CPU run agrees [{card}]"
    )
    what = f"config class {name}, sharded"
    x, payloads, starts, whole = sh_stream
    t_local = CL_SH_TOTAL // CL_SH_NTIME
    ov = fs.FrameSpec(cfg).frame_samples - 1
    k = shard_slots(cfg, t_local)
    mesh = make_mesh(n_time=CL_SH_NTIME, n_ch=1, devices=[DEV])
    res, got_sharded = counted(
        what, block_launches(cfg, 1), lambda: sharded_framesync(x, cfg, mesh, max_frames_per_shard=k))
    n_ok, expected, n_cross = check_stream_frames(
        what, res.payload_valid, res.start, res.payload, payloads, starts, whole,
        1.0, t_local, ov)
    check_metrics(what, res, CL_SH_TOTAL)
    cpu_mesh = make_mesh(n_time=CL_SH_NTIME, n_ch=1, devices=["cpu"])
    ref = sharded_framesync(x.cpu(), cfg, cpu_mesh, max_frames_per_shard=k)
    same_results(f"{what}, GPU against CPU", by_start(res), by_start(ref))
    print(
        f"{what} {CL_SH_BATCH} x {CL_SH_TOTAL} in {CL_SH_NTIME} shards: {n_ok}/{expected} whole "
        f"frames exactly once and bit-exact, {n_cross} across a shard boundary, CPU run agrees [{card}]"
    )
    return got_block, got_sharded


# ---------------------------------------------------------------------------
# phases P1-P4: the self-describing receiver and the sample-clock-drift path
# ---------------------------------------------------------------------------

ALL_CONFIGS = [(m, i, o) for m in range(11) for i in range(7) for o in range(8)]


def sweep_run(label: str, payload_len: int, mods, shards: int, card: str) -> dict:
    """P1 / P2: config_space_loopback over the configs of ``mods`` (all when
    None), on the samples of the reference's run in ``shards`` parts, counted
    as one step; every config must decode. Each block launches the correlator
    and extract once, recover once where the buffer is on the static path,
    and the Viterbi kernel once a config with an inner code (each config of a
    block is its own header group)."""
    configs = [c for c in ALL_CONFIGS if mods is None or c[0] in mods]
    per = -(-len(configs) // shards)
    blocks = sum(-(-len(configs[s : s + per]) // 8) for s in range(0, len(configs), per))
    n_syms = fs.max_frame_spec(payload_len).frame_syms
    static = n_syms < SFO_AUTO_SYMS
    want = {"correlator": blocks, "extract": blocks, "recover": blocks if static else 0,
            "viterbi": sum(1 for c in configs if c[1]), "halo": 0, "halo_wait": 0}
    t0 = time.perf_counter()
    res, got = counted(label, want, lambda: cs.config_space_loopback(
        payload_len=payload_len, mods=mods, shards=shards, device=DEV))
    secs = time.perf_counter() - t0
    if len(res) != len(configs):
        fail(f"{label}: {len(res)} results for {len(configs)} configs")
    bad = sorted(k for k, v in res.items() if not v)
    if bad:
        fail(f"{label}: configs that did not decode every frame exactly once: {bad}")
    print(f"{label}: {len(res)}/{len(res)} configs decode every frame bit-exactly against what "
          f"was sent ({'static' if static else 'SFO'} path, buffer {n_syms} symbols, {blocks} "
          f"blocks of up to 8 configs x 2 frames, the samples of the reference's run in "
          f"{shards} shards); {secs:.1f} s [{card}]")
    return got


def sfo_run(stream, card: str) -> dict:
    """P3: the stretched stream through framesync_fixed with and without
    sample-clock-drift tracking. Returns the launch counts of both steps."""
    x, payloads, n_frames, max_frames = stream
    expected = n_frames * BATCH
    got_by, share = {}, {}
    for track in ("auto", False):
        label = f"P3 SFO track_sfo={track!r}"
        want = {"correlator": 1, "extract": 1, "recover": 0 if track else 1,
                "viterbi": 0, "halo": 0, "halo_wait": 0}
        # track=False: the payload carrier tracker, which comes after symbol
        # recovery, slips on about a quarter of random 1200-byte QAM16
        # payloads even without noise or drift, in the JAX package too
        # (tests/test_torch_sfo.py); without it, the frames that fail are
        # those the symbol recovery failed
        res, got_by[label] = counted(label, want, lambda: framesync_fixed(
            x, P3_CFG, max_frames, track_sfo=track, track=False))
        if not bool(torch.isfinite(torch.view_as_real(res.symbols)).all()):
            fail(f"{label}: symbols are not finite")
        exact = (res.payload == payloads[:, None, :]).all(dim=-1) & res.payload_valid
        if bool((res.payload_valid & ~exact).any()):
            fail(f"{label}: a frame passed its CRC with another payload")
        n = int(exact.sum())
        if n > expected:
            fail(f"{label}: {n} decoded frames of {expected} sent")
        share[track] = n / expected
        print(f"{label}: {n}/{expected} frames bit-exact ({share[track]:.2%}), "
              f"{fs.FrameSpec(P3_CFG).frame_syms}-symbol frames at +-{P3_PPM:g} ppm, {P3_SNR:g} dB, "
              f"{BATCH} x {BLOCK} [{card}]")
    if share["auto"] < 0.99:
        fail(f"P3: tracked decode {share['auto']:.2%} < 99 %")
    if not share[False] < share["auto"]:
        fail("P3: the static path decodes as many frames as the tracked one")
    return got_by


INFO_EXACT = ("header_valid", "payload_valid", "modulation", "inner_code", "outer_code",
              "payload_len", "start", "batch")


def same_infos(what: str, a: list, b: list) -> None:
    """Two lists of packet_info dicts (each sorted by batch and start) carry
    the same frames: integers and payload bytes equal, evm within 0.02 dB,
    rssi 1e-3 dB, cfo 1e-6 rad/sample."""
    if len(a) != len(b):
        fail(f"{what}: {len(a)} infos against {len(b)}")
    for x, y in zip(a, b):
        for k in INFO_EXACT:
            if x[k] != y[k]:
                fail(f"{what}: {k} {x[k]} against {y[k]} (batch {x['batch']}, start {x['start']})")
        if not np.array_equal(x["payload"], y["payload"]):
            fail(f"{what}: payload bytes differ (batch {x['batch']}, start {x['start']})")
        for k, tol in (("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6)):
            if not abs(x[k] - y[k]) <= tol:
                fail(f"{what}: {k} {x[k]} against {y[k]}")


def flexrx_run(cfgs, block, card: str) -> dict:
    """P4: FlexRx at max_payload_len 64 on the mixed-config stream, plain and
    with expected_configs. Returns the launch counts of both steps."""
    x, payloads = block
    n_frames = payloads.shape[1]
    rx = FlexRx(max_payload_len=P4_PAYLOAD, max_frames_per_block=n_frames + 2)
    n_inner = sum(1 for c in cfgs if c[1])
    base = {"correlator": 1, "extract": 1, "recover": 0, "halo": 0, "halo_wait": 0}
    # a channel is one config group; speculation adds one group a channel
    infos, got = counted("P4 FlexRx", {**base, "viterbi": n_inner}, lambda: rx.work(x))
    expected = [(m, i, o, P4_PAYLOAD) for m, i, o in cfgs]
    infos_s, got_s = counted("P4 FlexRx speculative", {**base, "viterbi": 2 * n_inner},
                             lambda: rx.work_complete(rx.work_submit(x, expected_configs=expected)))
    same_infos("P4 speculative against plain", infos_s, infos)
    ok, false = cs.frame_outcomes(infos, cfgs, payloads, P4_PAYLOAD)
    total = BATCH * n_frames
    if int(false.sum()):
        fail(f"P4: {int(false.sum())} frames passed their CRC with a config or payload not sent")
    if int(ok.sum()) < 0.99 * total:
        fail(f"P4: decoded {int(ok.sum())} of {total} frames, need at least 99 %")
    cpu = FlexRx(max_payload_len=P4_PAYLOAD, max_frames_per_block=n_frames + 2,
                 device="cpu").work(x[:2].cpu())
    same_infos("P4 GPU against CPU", [d for d in infos if d["batch"] < 2], cpu)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rx.work(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step = float(np.median(times))
    print(f"P4 FlexRx: {int(ok.sum())}/{total} frames bit-exact against what was sent "
          f"({int(ok.sum()) / total:.2%}), no false CRC pass, {len(infos)} packet infos, "
          f"speculative run identical, channels 0-1 equal a CPU run; "
          f"{BATCH} channels x {BLOCK}, {len({c[0] for c in cfgs})} modulations, "
          f"{len({c[1] for c in cfgs})} inner and {len({c[2] for c in cfgs})} outer codes; "
          f"step {step * 1e3:.2f} ms, {BATCH * BLOCK / step:.4g} samples/s; launches {got} "
          f"(speculative {got_s}) [{card}]")
    return {"P4 FlexRx": got, "P4 FlexRx speculative": got_s}


# ---------------------------------------------------------------------------
# phases P5-P7: the continuous streaming receiver and the adaptation loop
# ---------------------------------------------------------------------------


def times_launches(per_step: dict, n: int) -> dict:
    return {k: v * n for k, v in per_step.items()}


class Joined:
    """Per-chunk results of one stream laid side by side: fields [B, n*K],
    ``start`` absolute (epoch + start, int64)."""

    def __init__(self, results):
        cat = lambda name: torch.cat([getattr(r, name) for r in results], dim=1)
        for name in COMPARED:
            setattr(self, name, cat(name))
        self.start = torch.cat([r.start.to(torch.int64) + r.epoch for r in results], dim=1)


def frame_set(results) -> set:
    """{(row, absolute start, payload bytes)} of the payload-valid slots."""
    j = Joined(results)
    v = j.payload_valid.cpu()
    rows, cols = torch.nonzero(v, as_tuple=True)
    st, pay = j.start.cpu(), j.payload.cpu().numpy()
    return {(int(b), int(st[b, k]), pay[b, k].tobytes()) for b, k in zip(rows.tolist(), cols.tolist())}


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def streaming_p5(cfg, snr, share, stream, card) -> dict:
    """P5 for one config: StreamingRx over P5_CHUNKS chunks of [64, 65,536]
    through run, superstep, push and native ingest, then run_adaptive on the
    stream tiled P5_TILES times and on a burst stream. Returns the launch
    counts of each."""
    name = config_name(cfg)
    x, payloads, starts, whole = stream
    k = shard_slots(cfg, BLOCK)  # the bench's (chunk_len + f - 1) // period + 2
    per_step = block_launches(cfg, 0)
    mk = lambda **kw: StreamingRx(cfg, BATCH, BLOCK, device=DEV, **kw)
    launches = {}

    rx = mk(max_frames_per_chunk=k)
    (ref, t_run), got = counted(f"P5 {name} run", times_launches(per_step, P5_CHUNKS),
                                lambda: wall(lambda: rx.run(x)))
    launches[f"P5 {name} run"] = got
    j = Joined(ref)
    n_ok, expected, _ = check_stream_frames(
        f"P5 {name} run", j.payload_valid, j.start, j.payload, payloads, starts, whole, share)
    ref_sorted = by_start(j)

    rx = mk(max_frames_per_chunk=k)
    sup, t_sup = [], 0.0
    for g in range(0, P5_CHUNKS, P5_PER_LAUNCH):
        (res, dt), got = counted(f"P5 {name} superstep", times_launches(per_step, P5_PER_LAUNCH),
                                 lambda: wall(lambda: rx.superstep(x[:, g * BLOCK : (g + P5_PER_LAUNCH) * BLOCK])))
        if res.mask.shape != (P5_PER_LAUNCH, BATCH, k):
            fail(f"P5 {name}: a superstep's mask has shape {tuple(res.mask.shape)}")
        sup.extend(split_results(res, P5_PER_LAUNCH))
        t_sup += dt
    launches[f"P5 {name} superstep x{P5_PER_LAUNCH}"] = got
    same_results(f"P5 {name} superstep against run", by_start(Joined(sup)), ref_sorted)

    rx = mk(max_frames_per_chunk=k)
    host = x.cpu().numpy()

    def pushed():
        out = []
        for pos in range(0, host.shape[1], P5_PUSH):
            out.extend(rx.push(host[:, pos : pos + P5_PUSH]))
        tail = rx.flush()
        return out + ([tail] if tail is not None else [])

    (res, t_push), _ = counted(f"P5 {name} push", times_launches(per_step, P5_CHUNKS),
                               lambda: wall(pushed))
    same_results(f"P5 {name} push {P5_PUSH} + flush against run", by_start(Joined(res)), ref_sorted)

    # native ingest: the channels interleaved sample by sample, as a
    # multi-channel receiver delivers them, through the ring in whole chunks
    rx = mk(max_frames_per_chunk=k)
    inter = np.ascontiguousarray(host.T).reshape(-1)

    def native():
        src = NativeChunkSource(inter, chunk_len=BLOCK * BATCH, capacity_chunks=2)
        out = [rx.step(torch.from_numpy(c.reshape(BLOCK, BATCH).T)) for c in src.chunks()]
        src.stop()
        return out

    (res, t_native), _ = counted(f"P5 {name} native ingest", times_launches(per_step, P5_CHUNKS),
                                 lambda: wall(native))
    if len(res) != P5_CHUNKS:
        fail(f"P5 {name}: native ingest gave {len(res)} chunks")
    same_results(f"P5 {name} native ingest against run", by_start(Joined(res)), ref_sorted)
    del host, inter

    # run_adaptive with the default (worst-case) provisioning on the stream
    # tiled: it starts at the smallest bucket, so its first call decodes
    # groups again, and settles
    rx_ad = mk()
    x_long = x.repeat(1, P5_TILES)
    n_long = P5_TILES * P5_CHUNKS

    def adaptive(stream, n_chunks, label):
        """run_adaptive on ``stream``: each chunk's window launches the
        path's kernels once, and once more for each group decoded again."""
        before = rx_ad.adaptive_redos
        want = lambda _: times_launches(
            per_step, n_chunks + P5_PER_LAUNCH * (rx_ad.adaptive_redos - before))
        (res, dt), got = counted_by(label, want, lambda: wall(
            lambda: rx_ad.run_adaptive(stream, P5_PER_LAUNCH)))
        return res, dt, got, rx_ad.adaptive_redos - before

    ad, t_ad, launches[f"P5 {name} run_adaptive"], redos_first = adaptive(
        x_long, n_long, f"P5 {name} run_adaptive")
    settled = rx_ad._adaptive_k
    total = x.shape[1]
    tiled_truth = (payloads.repeat(1, P5_TILES, 1),
                   torch.cat([starts + t * total for t in range(P5_TILES)], dim=1), whole.repeat(1, P5_TILES))
    ja = Joined(ad)
    n_tiles_ok, n_tiles, _ = check_stream_frames(
        f"P5 {name} run_adaptive", ja.payload_valid, ja.start, ja.payload, *tiled_truth, share)
    if frame_set(ad) != frame_set(mk(max_frames_per_chunk=k).run(x_long)):
        fail(f"P5 {name}: run_adaptive decoded another frame set than run")
    # a second call on the same stream starts at the settled bucket
    rx_ad.reset()
    ad2, t_ad2, _, redos_settled = adaptive(x_long, n_long, f"P5 {name} run_adaptive, settled")
    if frame_set(ad2) != frame_set(ad):
        fail(f"P5 {name}: the settled run_adaptive decoded another frame set")
    del x_long, ad, ad2, ja

    # a burst above the settled bucket in one group: decoded again, frames unchanged
    bx, bpay, bstarts, bwhole = burst_stream(cfg, snr, BATCH, P5_CHUNKS * BLOCK, (7 * BLOCK, 8 * BLOCK),
                                             torch.Generator(DEV).manual_seed(5), DEV)
    rx_ad.reset()
    burst, _, _, redos_burst = adaptive(bx, P5_CHUNKS, f"P5 {name} run_adaptive burst")
    if redos_burst < 1:
        fail(f"P5 {name}: the burst decoded no group again")
    jb = Joined(burst)
    nb_ok, nb, _ = check_stream_frames(f"P5 {name} burst", jb.payload_valid, jb.start, jb.payload,
                                       bpay, bstarts, bwhole, share)
    if frame_set(burst) != frame_set(mk().run(bx)):
        fail(f"P5 {name}: the burst's run_adaptive decoded another frame set than run")
    print(
        f"P5 StreamingRx {name} at {snr:g} dB, {P5_CHUNKS} chunks of {BATCH} x {BLOCK} "
        f"(window {BLOCK + rx.overlap}, {k} slots): run {n_ok}/{expected} whole frames at most once and "
        f"bit-exact, step {t_run / P5_CHUNKS * 1e3:.2f} ms ({BATCH * BLOCK * P5_CHUNKS / t_run:.4g} samples/s); "
        f"superstep x{P5_PER_LAUNCH} identical, {t_sup / P5_CHUNKS * 1e3:.2f} ms a chunk; "
        f"push {P5_PUSH} + flush identical, {t_push / P5_CHUNKS * 1e3:.2f} ms a chunk; "
        f"native ingest identical, {t_native / P5_CHUNKS * 1e3:.2f} ms a chunk; "
        f"run_adaptive on {P5_TILES} tiles ({n_long} chunks, default {rx_ad.max_frames} slots): "
        f"{n_tiles_ok}/{n_tiles} whole frames = run's, settled bucket {settled}, buckets run {sorted(rx_ad.adaptive_buckets)}, "
        f"groups decoded again {redos_first} (first call, {t_ad / n_long * 1e3:.2f} ms a chunk) and "
        f"{redos_settled} (settled, {t_ad2 / n_long * 1e3:.2f} ms a chunk); burst of back-to-back frames "
        f"in chunk 7: {redos_burst} group(s) decoded again, {nb_ok}/{nb} frames, frame set = run's [{card}]")
    return launches


def loop_checks(label: str, out: dict, dynamic: bool) -> None:
    """The loop's own checks: no false CRC pass, and a CPU engine fed the
    recorded feedback makes the same decisions in every generation."""
    if out["payload_exact"] != out["payload_valid"]:
        fail(f"{label}: {out['payload_valid'] - out['payload_exact']} frames passed their CRC "
             f"with bytes that were not sent")
    if out["payload_valid"] < 1:
        fail(f"{label}: no frame decoded")
    ce = CognitiveEngineBlock(channel="nonstationary" if dynamic else "stationary", seed=0)
    for g, (fbs, dec) in enumerate(zip(out["feedback"], out["decisions"])):
        if dynamic:
            ce.get_number()
        if ce.handle_batch(fbs) != dec:
            fail(f"{label}: a CPU engine fed the recorded feedback decides otherwise in generation {g}")


def loop_want(out: dict) -> dict:
    """One front end a generation (correlator, extract, recover: static path
    at payload 32); the Viterbi kernel once a commanded config group with an
    inner code (the speculative decode), and at most once more a decoded
    header group with an inner code."""
    n = len(out["commanded"])
    spec = sum(len({c for c in cmd if c[1]}) for cmd in out["commanded"])
    extra = sum(len({(f["modulation"], f["inner_code"], f["outer_code"]) for f in fbs
                     if f["header_valid"] and f["inner_code"]}) for fbs in out["feedback"])
    return {"correlator": n, "extract": n, "recover": n, "viterbi": (spec, spec + extra),
            "halo": 0, "halo_wait": 0}


def loop_run(label: str, iters: int, pipeline: bool, dynamic: bool, card: str):
    out, got = counted_by(label, loop_want, lambda: adapt_loop(
        BATCH, iters, P6_SNR, P6_PAYLOAD, pipeline=pipeline, dynamic=dynamic, seed=0, device=DEV))
    loop_checks(label, out, dynamic)
    st = out["stage_s"]
    print(f"{label}: {out['packets']} packets, {out['packets_per_sec']:.1f} packets/s, "
          f"payload_valid {out['payload_valid']}, payload_exact {out['payload_exact']}, "
          f"stages tx+channel {st['tx_channel']:.2f} s / rx {st['rx']:.2f} s / engine {st['engine']:.2f} s "
          f"of {out['wall_s']:.2f} s, {out['configs_visited']} configs visited, "
          f"final configs {out['final_configs'][:6]}{'...' if len(out['final_configs']) > 6 else ''}, "
          f"launches {got}; a CPU engine fed the feedback decides alike [{card}]")
    return out, got


def same_decisions(label: str, a: dict, b: dict) -> None:
    if a["decisions"] != b["decisions"] or a["feedback"] != b["feedback"]:
        fail(f"{label}: a second run with the same seed decided otherwise")


def loop_p6_p7(card: str) -> dict:
    """P6: the loop at bench/adapt_loop.py's defaults, pipelined (twice: the
    same decisions) and not. P7: the dynamic schedule, nonstationary, 40
    generations unpipelined (twice)."""
    launches = {}
    a, launches["P6 loop pipelined"] = loop_run("P6 loop pipelined", P6_ITERS, True, False, card)
    b, _ = loop_run("P6 loop pipelined, again", P6_ITERS, True, False, card)
    same_decisions("P6 pipelined", a, b)
    _, launches["P6 loop"] = loop_run("P6 loop unpipelined", P6_ITERS, False, False, card)
    c, launches["P7 loop dynamic"] = loop_run("P7 loop dynamic, nonstationary", P7_ITERS, False, True, card)
    d, _ = loop_run("P7 loop dynamic, again", P7_ITERS, False, True, card)
    same_decisions("P7", c, d)
    return launches


# ---------------------------------------------------------------------------
# phase P13: the program layer (CUDA graphs) against the eager bodies
# ---------------------------------------------------------------------------


def bits_of(t: torch.Tensor) -> torch.Tensor:
    """The bit pattern of a tensor (NaN equals NaN, -0 differs from 0)."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_bits(what: str, a, b) -> None:
    """Two results (FrameResults, tuples, dataclasses of tensors) are equal
    bit for bit, field by field."""
    ta, tb = [], []
    program.map_tensors(ta.append, a)
    program.map_tensors(tb.append, b)
    if len(ta) != len(tb):
        fail(f"{what}: {len(ta)} outputs against {len(tb)}")
    for i, (x, y) in enumerate(zip(ta, tb)):
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(bits_of(x), bits_of(y)):
            fail(f"{what}: output {i} of the graph ({tuple(x.shape)} {x.dtype}) differs from the "
                 f"eager body's ({tuple(y.shape)} {y.dtype})")


def eager_steps(rx, chunks, ks) -> list:
    """The eager body of ``rx``'s step program, chunk by chunk at slot
    count ``ks[i]``, the window base as the step writes it."""
    out = []
    for chunk, k in zip(chunks, ks):
        base = torch.full((), rx._base(), dtype=torch.int64, device=DEV)
        res = rx.program.body(("step", k))(chunk, base)
        rx._samples_consumed += rx.chunk_len
        out.append(dataclasses.replace(res, epoch=rx.start_epoch))
    return out


def host_profile(fn) -> tuple[int, float, float, dict]:
    """One call of ``fn`` under torch.profiler: the host's CUDA API calls
    (the synchronise that ends the call excluded), the device-busy ms, the
    device-busy share of the call and the calls by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = prof.key_averages()
    api = {e.key: e.count for e in evs if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("cu") and "Synchronize" not in e.key}
    busy = sum(e.device_time_total for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return sum(api.values()), busy * 1e3, busy / wall, api


def med_ms(fn, reps: int = 3) -> float:
    return float(np.median([wall(fn)[1] for _ in range(reps)])) * 1e3


def programs_stream(cfg, stream, card) -> dict:
    """P13 for one config on P5's stream: step, superstep, run and
    run_adaptive through their graphs against the eager step body, bit for
    bit; eager and graph ms a chunk in the same call; the host's CUDA calls
    and the device-busy share of a step and a superstep. Returns launches."""
    name = config_name(cfg)
    x = stream[0]
    k = shard_slots(cfg, BLOCK)
    per_step = block_launches(cfg, 0)
    mk = lambda **kw: StreamingRx(cfg, BATCH, BLOCK, max_frames_per_chunk=k, device=DEV, **kw)
    chunks = [x[:, c * BLOCK : (c + 1) * BLOCK] for c in range(P5_CHUNKS)]
    rx_e = mk()
    ref = eager_steps(rx_e, chunks, [k] * P5_CHUNKS)
    launches = {}

    rx = mk()
    t0 = time.perf_counter()
    first = rx.step(chunks[0])  # capture
    t_capture = time.perf_counter() - t0
    same_bits(f"P13 {name} step (first call)", first, ref[0])
    rx.reset()
    got, launches[f"P13 {name} step x{P5_CHUNKS}"] = counted(
        f"P13 {name} graph steps", times_launches(per_step, P5_CHUNKS),
        lambda: [rx.step(c) for c in chunks])
    for c in range(P5_CHUNKS):
        same_bits(f"P13 {name} step, chunk {c}", got[c], ref[c])

    rx_s = mk()
    sup = [rx_s.superstep(x[:, g * BLOCK : (g + P5_PER_LAUNCH) * BLOCK])
           for g in range(0, P5_CHUNKS, P5_PER_LAUNCH)]
    for c, res in enumerate(s for st in sup for s in split_results(st, P5_PER_LAUNCH)):
        same_bits(f"P13 {name} superstep x{P5_PER_LAUNCH}, chunk {c}", res, ref[c])
    rx_r = mk()
    for c, res in enumerate(rx_r.run(x)):
        same_bits(f"P13 {name} run, chunk {c}", res, ref[c])
    rx_a = StreamingRx(cfg, BATCH, BLOCK, device=DEV)
    ad = rx_a.run_adaptive(x, P5_PER_LAUNCH)
    ks = [r.mask.shape[-1] for r in ad]
    for c, (res, e) in enumerate(zip(ad, eager_steps(StreamingRx(cfg, BATCH, BLOCK, device=DEV),
                                                      chunks, ks))):
        same_bits(f"P13 {name} run_adaptive, chunk {c} at {ks[c]} slots", res, e)

    # times a chunk, eager and graph in turns
    def eager_pass():
        rx_e.reset()
        eager_steps(rx_e, chunks, [k] * P5_CHUNKS)

    def graph_pass():
        rx.reset()
        for c in chunks:
            rx.step(c)

    def super_pass():
        rx_s.reset()
        for g in range(0, P5_CHUNKS, P5_PER_LAUNCH):
            rx_s.superstep(x[:, g * BLOCK : (g + P5_PER_LAUNCH) * BLOCK])

    t_e1, t_g1, t_s1 = med_ms(eager_pass), med_ms(graph_pass), med_ms(super_pass)
    t_s2, t_g2, t_e2 = med_ms(super_pass), med_ms(graph_pass), med_ms(eager_pass)
    rx.reset()
    rx_e.reset()
    n_e, _, busy_e, _ = host_profile(lambda: eager_steps(rx_e, chunks[:1], [k]))
    n_g, ms_g, busy_g, api_g = host_profile(lambda: rx.step(chunks[0]))
    rx_s.reset()
    n_s, ms_s, busy_s, api_s = host_profile(lambda: rx_s.superstep(x[:, : P5_PER_LAUNCH * BLOCK]))
    caps = {str(key): round(c.capture_s, 3) for key, c in
            {**rx.program.graphs, **rx_s.program.graphs, **rx_a.program.graphs}.items()}
    print(f"P13 programs StreamingRx {name}, {P5_CHUNKS} chunks of {BATCH} x {BLOCK} ({k} slots): "
          f"step, superstep x{P5_PER_LAUNCH}, run and run_adaptive (slots {sorted(set(ks))}) equal "
          f"the eager step body bit for bit in every field; ms a chunk, in turns eager / graph step "
          f"/ graph superstep: {t_e1 / P5_CHUNKS:.2f} / {t_g1 / P5_CHUNKS:.2f} / "
          f"{t_s1 / P5_CHUNKS:.2f}, then {t_e2 / P5_CHUNKS:.2f} / {t_g2 / P5_CHUNKS:.2f} / "
          f"{t_s2 / P5_CHUNKS:.2f}; host CUDA calls a step eager {n_e}, graph {n_g} {api_g}, "
          f"a superstep of {P5_PER_LAUNCH} {n_s} {api_s}; device busy a step alone eager "
          f"{busy_e:.1%}, graph {busy_g:.1%} ({ms_g:.2f} ms), a superstep {busy_s:.1%} "
          f"({ms_s:.2f} ms), a step's busy ms over the graph's ms a chunk in a stream "
          f"{ms_g / (t_g1 / P5_CHUNKS):.1%} / {ms_g / (t_g2 / P5_CHUNKS):.1%}; first step with its capture "
          f"{t_capture * 1e3:.0f} ms; capture seconds by key {caps} [{card}]")
    return launches


def groups_of(packed: np.ndarray, max_payload_len: int) -> dict:
    """FlexRx's payload groups of a packed [10, B, K] plane: {(mod, inner,
    outer, payload_len): [flat slot index]} of the header-valid slots, as
    ``work_complete`` groups them."""
    k = packed.shape[2]
    groups: dict[tuple, list[int]] = {}
    for b, s in zip(*np.nonzero((packed[0] > 0.5) & (packed[1] > 0.5))):
        m, i, o, pl = (int(packed[r, b, s]) for r in (3, 4, 5, 2))
        if 0 <= m < 11 and 0 <= i < 7 and 0 <= o < 8 and 0 < pl <= max_payload_len:
            groups.setdefault((m, i, o, pl), []).append(int(b) * k + int(s))
    return groups


def programs_flexrx(label: str, rx, x, card) -> dict:
    """P13 for a FlexRx block: the front end's graph and every payload
    group's graph against their eager bodies, bit for bit; the front end
    plus the groups through graphs and eagerly, in turns. Returns launches."""
    key = (x.shape[0], x.shape[1], rx.n_syms, rx.max_frames, rx.threshold, DEV)
    width = rx.max_payload_len + 1

    def graphs():
        syms, evm, packed = blocks._SYNC(key, x, device=DEV)
        flat, evm_flat = syms.reshape((-1,) + syms.shape[2:]), evm.reshape(-1)
        groups = groups_of(packed.cpu().numpy(), rx.max_payload_len)
        return (syms, evm, packed), {g: blocks._decode_group(FrameConfig(*g), flat, evm_flat, idx, width)
                                     for g, idx in groups.items()}

    def eager():
        syms, evm, packed = blocks._SYNC.body(key)(x)
        flat, evm_flat = syms.reshape((-1,) + syms.shape[2:]), evm.reshape(-1)
        groups = groups_of(packed.cpu().numpy(), rx.max_payload_len)
        return (syms, evm, packed), {
            g: blocks._PAYLOAD.body((FrameConfig(*g), flat.shape[0], len(idx), width, DEV))(
                flat, evm_flat, torch.tensor(idx, device=DEV)) for g, idx in groups.items()}

    graphs()  # the captures
    n_static = int(fs.max_frame_spec(rx.max_payload_len).frame_syms < SFO_AUTO_SYMS)
    want = lambda out: {"correlator": 1, "extract": 1, "recover": n_static,
                        "viterbi": sum(1 for g in out[1] if g[1]), "halo": 0, "halo_wait": 0}
    (front, groups), got = counted_by(f"P13 {label} graphs", want, graphs)
    e_front, e_groups = eager()
    same_bits(f"P13 {label} front end", front, e_front)
    if groups.keys() != e_groups.keys():
        fail(f"P13 {label}: the graph and eager front ends group the slots otherwise")
    for g in groups:
        same_bits(f"P13 {label} payload group {g}", groups[g], e_groups[g])
    t_e1, t_g1 = med_ms(eager, 2), med_ms(graphs, 2)
    t_g2, t_e2 = med_ms(graphs, 2), med_ms(eager, 2)
    n_g, _, busy_g, api_g = host_profile(graphs)
    n_valid = sum(int(v[:, -1].sum()) for v in groups.values())
    print(f"P13 programs {label}: front end and {len(groups)} payload groups ({n_valid} CRC-valid "
          f"frames) equal the eager bodies bit for bit; front end + groups, in turns eager / graph: "
          f"{t_e1:.2f} / {t_g1:.2f} ms, then {t_e2:.2f} / {t_g2:.2f} ms; through the graphs "
          f"{n_g} host CUDA calls {api_g}, device busy {busy_g:.1%}; launches {got} [{card}]")
    return {f"P13 {label}": got}


def programs_tx_detector(x, card) -> None:
    """P13: FlexTx's and FrameDetectorCC's graphs against their eager bodies."""
    cfg = FrameConfig(3, 2, 2, 64)
    payloads = torch.randint(0, 256, (BATCH, 64), dtype=torch.uint8, device=DEV,
                             generator=torch.Generator(DEV).manual_seed(13))
    tx = FlexTx(cfg.modulation, cfg.inner_code, cfg.outer_code, device=DEV)
    tx_key = (cfg.modulation, cfg.inner_code, cfg.outer_code, 64, BATCH, DEV)
    for i in range(2):
        same_bits(f"P13 FlexTx call {i}", tx.send_pkt(payloads).data,
                  blocks._TX.body(tx_key)(payloads))
    det = FrameDetectorCC(device=DEV)
    det_key = (x.shape[0], x.shape[1], det.max_frames, det.threshold, DEV)
    for i in range(2):
        same_bits(f"P13 FrameDetectorCC call {i}", det.work(x)[1], blocks._DETECT.body(det_key)(x)[1])
    print(f"P13 programs FlexTx {config_name(cfg)} x {BATCH} and FrameDetectorCC on "
          f"{x.shape[0]} x {x.shape[1]}: graphs equal the eager bodies bit for bit, twice each, "
          f"{det.num_frames} detections counted [{card}]")


def programs_p13(p5_streams, p4_block, p6_x, card) -> dict:
    """P13: the program layer at full width, each graph against its eager
    body. Returns the launch counts of its graph steps."""
    launches = {}
    for (cfg, _, _), stream in zip(CONFIGS, p5_streams):
        launches.update(programs_stream(cfg, stream, card))
    launches.update(programs_flexrx(
        "P4 FlexRx block", FlexRx(max_payload_len=P4_PAYLOAD, max_frames_per_block=p4_block[1].shape[1] + 2,
                                  device=DEV), p4_block[0], card))
    launches.update(programs_flexrx(
        "P6 loop generation", FlexRx(max_payload_len=P6_PAYLOAD, max_frames_per_block=2, device=DEV),
        p6_x, card))
    programs_tx_detector(p4_block[0], card)
    return launches


# ---------------------------------------------------------------------------
# phases P8-P10: the resampled receiver, slip_retry, the flowgraph layer
# ---------------------------------------------------------------------------


def resample_channels(x: torch.Tensor, rates, compute_dtype=torch.bfloat16, rank: int = 4):
    """bench.py's per-channel resampler: one group of channels a rate,
    resampled to the block's length, bf16 planes at rank 4 by default."""
    return arbitrary_groups(x, rates, x.shape[1], compute_dtype=compute_dtype,
                            rank=rank).to(torch.complex64)


def whole_frames(cfg) -> int:
    """Frames of a tiled_stream row that lie wholly in the block: the most a
    row can decode."""
    f = fs.FrameSpec(cfg).frame_samples
    period = 37 + f + int(0.8 * f)
    return sum(1 for i in range(BLOCK // period + 1) if 37 + i * period + f <= BLOCK)


def resampler_precisions(x: torch.Tensor, rates, card: str) -> dict:
    """P8's resampler on the card three ways (float64; float32 with TF32 off;
    bf16 operands and planes), each held against the same function on the
    CPU on the first row of every group (each group has its own plan), and
    timed: the plane convolution alone, on the operands the resampler gives
    it, and the whole arbitrary_groups, at 64 x 65,536 and rank 4."""
    rows, H = lowrank_operands(x, rates, x.shape[1], 33, 0.5 * min(1.0, min(rates)), 4)
    rows = rows.contiguous()
    firsts = list(range(0, x.shape[0], x.shape[0] // len(rates)))
    cpu_rows = x[firsts].cpu()
    out = {}
    for name, dt, tol_max, tol_rms in (("float64", torch.float64, 1e-5, None),
                                       ("float32", torch.float32, 1e-5, None),
                                       ("bf16", torch.bfloat16, 1e-2, 5e-3)):
        got = resample_channels(x, rates, dt)[firsts].cpu()
        # the CPU's reference in the same type (float32 for float64: the
        # card's float64 must not be worse than the CPU's float32), one row
        # a group
        ref = resample_channels(cpu_rows, rates, torch.float32 if dt == torch.float64 else dt)
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        rms = float(torch.sqrt(torch.mean((got - ref).abs() ** 2) / torch.mean(ref.abs() ** 2)))
        if not err <= tol_max * scale or (tol_rms is not None and not rms <= tol_rms):
            fail(f"P8 resampler {name}: the card differs from the CPU by {err} (scale {scale}), "
                 f"RMS {rms}")
        out[name] = {
            "max_abs_err_vs_cpu": err, "rms_rel_err_vs_cpu": rms,
            "conv_ms": time_ms(lambda: plane_conv(rows, H, dt), 10),
            "resampler_ms": time_ms(lambda: resample_channels(x, rates, dt), 5),
        }
    print(f"P8 resampler at {x.shape[0]} x {x.shape[1]}, rank 4, planes [{rows.shape[0]}, 4, "
          f"{rows.shape[-1] - 32}]: " + "; ".join(
              f"{k} conv {v['conv_ms']:.4f} ms, arbitrary_groups {v['resampler_ms']:.4f} ms, "
              f"against the CPU max {v['max_abs_err_vs_cpu']:.3g} RMS {v['rms_rel_err_vs_cpu']:.3g}"
              for k, v in out.items()) + f" [{card}]")
    return out


def resampled_run(cfg, snr, share, stream, card) -> dict:
    """P8 for one config: arbitrary_groups (bf16, rank 4) then
    framesync_fixed, as one counted step. Returns its launch counts."""
    x, payloads, n_frames, max_frames, rates = stream
    name = config_name(cfg)

    def step():
        y = resample_channels(x, rates)
        return y, framesync_fixed(y, cfg, max_frames)

    (y, res), got = counted(f"P8 resampled {name}", block_launches(cfg, 0), step)
    n_ok, expected = check_frames(res, payloads, n_frames, share, cfg,
                                  most=whole_frames(cfg) * BATCH)
    check_against_cpu(y, res, cfg, max_frames)
    step_s = []
    for _ in range(3):
        step_s.append(wall(step)[1])
    step_ms = float(np.median(step_s)) * 1e3
    print(f"P8 resampled receiver {name} payload {cfg.payload_len} at {snr:g} dB, {BATCH} x "
          f"{BLOCK} in {len(rates)} groups at {RESAMPLED_PPMS} ppm (bf16 planes, rank 4, "
          f"frames ending {RESAMPLED_TAIL_MARGIN} samples clear of the end expected): {n_ok}/{expected} "
          f"frames bit-exact (at most {whole_frames(cfg) * BATCH}), rows 0-1 decoded again on the "
          f"CPU agree; step {step_ms:.2f} ms, {BATCH * BLOCK / step_ms * 1e3:.4g} samples/s; "
          f"launches {got} [{card}]")
    return got


def slip_retry_run(card: str) -> dict:
    """P9: decode_payload_symbols on the faded and slipped frames, with and
    without slip_retry, each one counted step; both against a CPU run."""
    syms, payloads = fade_slip_symbols(P9_CFG, P9_FRAMES, seed=9, device=DEV)
    want = {"correlator": 0, "extract": 0, "recover": 0, "viterbi": 1, "halo": 0, "halo_wait": 0}
    launches, n = {}, {}
    for retry in (True, False):
        label = f"P9 slip_retry={retry}"
        (msg, ok), launches[label] = counted(label, want, lambda: decode_payload_symbols(
            syms, P9_CFG, noise_var=P9_NOISE_VAR, slip_retry=retry))
        n[retry] = int(((msg == payloads).all(dim=-1) & ok).sum())
        if bool((ok & ~(msg == payloads).all(dim=-1)).any()):
            fail(f"{label}: a frame passed its CRC with another payload")
        msg_c, ok_c = decode_payload_symbols(syms.cpu(), P9_CFG, noise_var=P9_NOISE_VAR,
                                             slip_retry=retry)
        if not (torch.equal(msg.cpu(), msg_c) and torch.equal(ok.cpu(), ok_c)):
            fail(f"{label}: the card and the CPU decode otherwise")
    if n[True] != P9_FRAMES or n[False] != 0:
        fail(f"P9: slip_retry recovered {n[True]} of {P9_FRAMES}, without it {n[False]} decoded")
    print(f"P9 slip_retry {config_name(P9_CFG)}: {n[True]}/{P9_FRAMES} faded and slipped frames "
          f"recovered bit-exactly with slip_retry (one Viterbi launch over {3 * P9_FRAMES} "
          f"candidates), {n[False]}/{P9_FRAMES} without; both equal a CPU run [{card}]")
    return launches


def flowgraph_run(card: str) -> dict:
    """P10: the package's loopback and adaptation graphs on the card."""
    front = lambda n: {"correlator": n, "extract": n, "recover": n}
    fg = Flowgraph.load(os.path.join(GRAPHS_DIR, "loopback.yaml"), device=DEV)
    got_pay = []
    fg.blocks["rx"].bus.subscribe("payload_data", lambda pdu: got_pay.append(np.asarray(pdu.data)))
    (_, t_loop), launches_loop = counted(
        "P10 loopback graph", {**front(P10_LOOPBACK), "viterbi": 0, "halo": 0, "halo_wait": 0},
        lambda: wall(lambda: fg.run(P10_LOOPBACK)))
    sent = fg.blocks["src"].sent
    if len(got_pay) != P10_LOOPBACK or not all(np.array_equal(a, b) for a, b in zip(sent, got_pay)):
        fail(f"P10 loopback graph: {len(got_pay)}/{P10_LOOPBACK} payloads, not all equal to those sent")

    fg = Flowgraph.load(os.path.join(GRAPHS_DIR, "adaptation_loop.yaml"), device=DEV)
    ce = fg.blocks["ce"]
    ce.engine.rng = random.Random(0)  # the graph's engine is unseeded; replayed below
    infos, decisions, steps = [], [], []
    fg.blocks["rx"].bus.subscribe("packet_info", lambda info: infos.append(info))
    fg.nodes["ce"].wires["configuration"].append(lambda conf: decisions.append(conf))

    def run():
        for _ in range(P10_ADAPT):
            n = len(infos)
            fg.run(1)
            steps.append(infos[n:])

    def want(_):
        coded = sum(len({(d["modulation"], d["inner_code"], d["outer_code"], d["payload_len"])
                         for d in st if d["inner_code"]}) for st in steps)
        return {**front(P10_ADAPT), "viterbi": coded, "halo": 0, "halo_wait": 0}

    (_, t_adapt), launches_adapt = counted_by("P10 adaptation graph", want, lambda: wall(run))
    if ce.num_packets != len(infos) or len(decisions) != len(infos) or not infos:
        fail(f"P10 adaptation graph: {len(infos)} packet infos, {len(decisions)} decisions, "
             f"engine saw {ce.num_packets}")
    ref = CognitiveEngineBlock(ce_type="epsilon_greedy", seed=0)
    for i, (info, conf) in enumerate(zip(infos, decisions)):
        if ref.handler(info) != conf:
            fail(f"P10 adaptation graph: a CPU engine fed the recorded packet infos decides "
                 f"otherwise at packet {i}")
    valid = sum(d["payload_valid"] for d in infos)
    configs = sorted({(d["modulation"], d["inner_code"], d["outer_code"]) for d in infos})
    print(f"P10 flowgraph: loopback.yaml {len(got_pay)}/{P10_LOOPBACK} packets bit-exact, "
          f"{P10_LOOPBACK / t_loop:.1f} packets/s; adaptation_loop.yaml {P10_ADAPT} packets, "
          f"{len(infos)} decoded headers, {valid} valid payloads, {len(configs)} configs visited, "
          f"{P10_ADAPT / t_adapt:.1f} packets/s, a CPU engine fed the recorded infos decides alike; "
          f"launches {launches_loop} / {launches_adapt} [{card}]")
    return {"P10 loopback graph": launches_loop, "P10 adaptation graph": launches_adapt}


# ---------------------------------------------------------------------------
# phases P11-P12: the receiver across processes, and the demos
# ---------------------------------------------------------------------------


def cfg_tuple(cfg) -> tuple:
    return (cfg.modulation, cfg.inner_code, cfg.outer_code, cfg.payload_len)


def same_stats(what, a, b) -> None:
    """evm, rssi and cfo of the detected slots of two runs, each row's slots
    in the order of their start: within 0.02 dB, 1e-3 dB, 1e-6 rad/sample."""
    def ordered(res, name):
        key = torch.where(res.mask, res.start.to(torch.int64), torch.iinfo(torch.int64).max)
        order = torch.sort(key, dim=1, stable=True).indices
        return torch.gather(getattr(res, name).cpu(), 1, order.cpu())
    m = ordered(a, "mask")
    for name, tol in (("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6)):
        d = float((ordered(a, name) - ordered(b, name))[m].abs().max())
        if not d <= tol:
            fail(f"{what}: {name} differs by {d} (tolerance {tol})")


def stream_mem_ops_attributes() -> str:
    """The card's attributes that say whether CUDA's stream memory
    operations (cuStreamWaitValue64) could order a step instead of the
    kernels' own flags, read through the driver library."""
    cu = ctypes.CDLL("libcuda.so.1")
    dev = ctypes.c_int()
    if cu.cuDeviceGet(ctypes.byref(dev), DEV.index) != 0:
        fail("cuDeviceGet failed")
    out = []
    for name, attr in (("CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1", 92),
                       ("CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS", 122)):
        value = ctypes.c_int()
        rc = cu.cuDeviceGetAttribute(ctypes.byref(value), attr, dev)
        if rc != 0:
            fail(f"reading {name}: CUDA driver error {rc}")
        out.append(f"{name} = {value.value}")
    return ", ".join(out)


def check_p11_interface(outs: list, world: int) -> None:
    """P11's ranks joined by the JAX form of init_distributed; make_mesh()
    of no extents is every rank on time; psum(mesh, "time") of each config's
    step is the sum of every rank's own metrics (the grid's one ch column)
    and psum(mesh, "ch") the rank's own (a time row of one rank): the counts
    exactly, the dB sums to 1e-6 relative."""
    want = [("jax", r, world) for r in range(world)]
    if outs[0]["joined"] != want:
        fail(f"P11: the ranks joined as {outs[0]['joined']}, expected {want}")
    print(f"P11 join: every rank by init_distributed(coordinator=\"127.0.0.1:<port>\", "
          f"num_processes={world}, process_id=r, device=\"cuda:{DEV.index}\"): {outs[0]['joined']}")
    meshes = outs[0]["mesh_of_no_extents"]
    grid = (P11_RANKS[0], P11_RANKS[1], P11_RANKS)
    if meshes != [{"world": (world, 1, (world, 1)), "grid": grid}] * world:
        fail(f"P11: make_mesh of no extents gave {meshes}")
    print(f"P11 make_mesh(devices=[dev]) of no extents on every rank: (n_time, n_ch, ranks) = "
          f"{meshes[0]['world']}; with ranks={P11_RANKS}: {meshes[0]['grid']}")
    for out in outs:
        if "metrics_by_axes" not in out:
            continue
        by_rank = out["metrics_by_axes"]
        total = {n: sum(m["own"][n] for m in by_rank) for n in by_rank[0]["own"]}
        for r, m in enumerate(by_rank):
            for axes, want_m in (("time", total), ("ch", m["own"]), (None, total)):
                for n, v in want_m.items():
                    ok = m[axes][n] == v if isinstance(v, int) else (
                        abs(m[axes][n] - v) <= 1e-6 * max(1.0, abs(v)))
                    if not ok:
                        fail(f"{out['name']}: rank {r} psum(mesh, {axes!r}) {n} = {m[axes][n]}, "
                             f"expected {v}")
        print(f"{out['name']}: psum(mesh, \"time\") on every rank = the sum of the ranks' own "
              f"metrics (frames_detected {[m['own']['frames_detected'] for m in by_rank]} -> "
              f"{[m['time']['frames_detected'] for m in by_rank]}); psum(mesh, \"ch\") = the "
              f"rank's own ({[m['ch']['frames_detected'] for m in by_rank]})")


def distributed_p11(card: str) -> tuple[dict, dict]:
    """P11: the sharded receiver over two processes on the card (four time
    shards each, gloo for setup and the metrics, the halo pushed across
    the process boundary by the kernel through CUDA IPC and ordered by
    flags on the card), both
    configs at the sharded shape, then three chunks of ShardedStreamingRx;
    each held against the one-process run on the same samples. Returns the
    launches of every rank's step and the halo kernel's figures."""
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(f"P11 compute mode: {mode.stdout.strip()} (two processes on one card need Default)")
    print(f"P11 order of a step: flags on the card, stored by the halo kernel's last block and by "
          f"halo_order (st.release.sys), awaited by halo_order polling (ld.acquire.sys); "
          f"{stream_mem_ops_attributes()} (cuStreamWaitValue64 is not used)")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(P11_SEED)
    mesh = make_mesh(n_time=SH_NTIME, n_ch=1, devices=[DEV])
    t_local = SH_TOTAL // SH_NTIME
    jobs, refs = [], []
    for cfg, snr, share in CONFIGS:
        stream = long_stream(cfg, snr, SH_BATCH, SH_TOTAL, gen, DEV)
        k = shard_slots(cfg, t_local)
        ref, _ = wall(lambda: sharded_framesync(stream[0], cfg, mesh, max_frames_per_shard=k))
        one_ms = float(np.median([wall(lambda: sharded_framesync(
            stream[0], cfg, mesh, max_frames_per_shard=k))[1] for _ in range(5)])) * 1e3
        jobs.append(Job(f"P11 {config_name(cfg)}", cfg_tuple(cfg), stream[0].cpu().numpy(),
                        SH_NTIME, 1, k=k, reps=P11_REPS))
        refs.append((cfg, snr, share, stream, ref, one_ms, k))
    st_cfg, st_snr = CONFIGS[0][0], CONFIGS[0][1]
    st_x, st_pay, st_starts, st_whole = long_stream(st_cfg, st_snr, SH_BATCH, 3 * SH_TOTAL, gen, DEV)
    st_window, st_k = streaming_shapes(st_cfg)
    rx = ShardedStreamingRx(st_cfg, mesh, batch=SH_BATCH, chunk_len=SH_TOTAL, max_frames_per_shard=st_k)
    st_ref = [rx.step(st_x[:, c * SH_TOTAL : (c + 1) * SH_TOTAL])[0] for c in range(3)]
    jobs.append(Job("P11 streaming " + config_name(st_cfg), cfg_tuple(st_cfg), st_x.cpu().numpy(),
                    SH_NTIME, 1, k=st_k, chunk=SH_TOTAL))
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    world = P11_RANKS[0] * P11_RANKS[1]
    outs = spawn_ranks(world, jobs, f"cuda:{DEV.index}", ranks=P11_RANKS, timeout_s=P11_TIMEOUT_S,
                       joins=("jax",))
    spawn_s = time.perf_counter() - t0
    check_p11_interface(outs, world)
    launches, halo = {}, {"also_checked": [], "cross_process": []}
    for (cfg, snr, share, stream, ref, one_ms, k), out in zip(refs, outs):
        what = out["name"]
        x, payloads, starts, whole = stream
        for r, counts in enumerate(out["launches"]):
            want = block_launches(cfg, 1, rank_waits(r, P11_RANKS))
            if counts != want:
                fail(f"{what}: rank {r} launched {counts}, expected {want}")
            launches[f"{what} rank {r}"] = counts
        if out["windows_exact"] != [True] * len(out["launches"]):
            fail(f"{what}: the windows after the push differ from halo_windows_ref")
        got = out["res"]
        same_results(f"{what}, two processes against one", by_start(got), by_start(ref))
        same_stats(f"{what}, two processes against one", got, ref)
        ov = fs.FrameSpec(cfg).frame_samples - 1
        n_ok, expected, n_cross = check_stream_frames(
            what, got.payload_valid.to(DEV), got.start.to(DEV), got.payload.to(DEV), payloads,
            starts, whole, share, t_local, ov)
        # frames that run from rank 0's block into rank 1's
        edge = SH_TOTAL // P11_RANKS[0]
        across = int((got.payload_valid & (got.start >= edge - ov) & (got.start < edge)).sum())
        if across == 0:
            fail(f"{what}: no decoded frame runs across the process boundary")
        want = LinkMetrics.from_results(ref, SH_TOTAL)
        m = out["metrics"]
        for name in ("samples", "frames_detected", "headers_valid", "payloads_valid"):
            if m[name] != int(getattr(want, name)):
                fail(f"{what}: all-reduced {name} {m[name]} against one process's {int(getattr(want, name))}")
        for name in ("sum_evm_db", "sum_rssi_db"):
            ref_v = float(getattr(want, name))
            if not abs(m[name] - ref_v) <= 1e-3 * max(1.0, abs(ref_v)):
                fail(f"{what}: all-reduced {name} {m[name]} against one process's {ref_v}")
        b_local, n_local, w = SH_BATCH, SH_NTIME // P11_RANKS[0], t_local + ov
        bms, by = bound(b_local * n_local * t_local * 8 + n_local * b_local * w * 8, 0)
        halo["cross_process"].append({
            "shapes": f"x_local [{b_local}, {n_local * t_local}] c64 -> [{n_local}, {b_local}, {w}] "
                      f"c64 a rank, the head of {b_local} x {ov} pushed across processes",
            "ms": out["kernel_ms"], "ms_alone": out["kernel_alone_ms"], "bound_ms": bms,
            "bound_by": by, "plain_ms": out["plain_ms"], "library_ms": None,
            "push_and_wait_ms": out["push_wait_ms"], "step_ms": out["step_ms"],
            "one_process_step_ms": one_ms,
        })
        halo["also_checked"].append(
            f"P11 {config_name(cfg)}: x_local [{b_local}, {n_local * t_local}] on each of 2 "
            f"processes, n_time {n_local}, ov {ov}, pushed across the process boundary")
        print(f"{what} on 2 processes x {n_local} shards (CUDA IPC push, flags on the card): "
              f"{n_ok}/{expected} whole frames exactly once and bit-exact, {n_cross} across a shard "
              f"boundary, {across} across the process boundary; windows equal halo_windows_ref on "
              f"both ranks; gathered slots equal the one-process run by start; all-reduced "
              f"LinkMetrics equal one process's; launches by rank {out['launches']}; halo kernel "
              f"{[round(v, 4) for v in out['kernel_ms']]} ms by rank launching together, "
              f"{[round(v, 4) for v in out['kernel_alone_ms']]} alone (bound {bms:.4f}; the plain "
              f"version with the heads through gloo {[round(v, 3) for v in out['plain_ms']]}), "
              f"push + wait {[round(v, 4) for v in out['push_wait_ms']]} ms, step "
              f"{[round(v, 2) for v in out['step_ms']]} ms on two processes against {one_ms:.2f} "
              f"ms on one [{card}]")
    st = outs[-1]
    what = st["name"]
    for c, step in enumerate(st["steps"]):
        for r, counts in enumerate(step["launches"]):
            if counts != block_launches(st_cfg, 1, rank_waits(r, P11_RANKS)):
                fail(f"{what} step {c}: rank {r} launched {counts}")
    for r, counts in enumerate(st["launches"]):
        launches[f"{what} rank {r} (3 steps)"] = counts
    got = [step["res"] for step in st["steps"]]
    j = Joined(got)
    n_ok, expected, _ = check_stream_frames(
        what, j.payload_valid.to(DEV), j.start.to(DEV), j.payload.to(DEV), st_pay, st_starts,
        st_whole, 1.0)
    if frame_set(got) != frame_set(st_ref):
        fail(f"{what}: two processes decoded another frame set than one")
    if sum(step["metrics"]["payloads_valid"] for step in st["steps"]) != n_ok:
        fail(f"{what}: the all-reduced metrics do not count the frames decoded")
    print(f"{what}, 3 chunks of {SH_BATCH} x {SH_TOTAL} on 2 processes: {n_ok}/{expected} whole "
          f"frames exactly once and bit-exact, the frame set of one process; P11 spawn to end "
          f"{spawn_s:.1f} s [{card}]")
    return launches, halo


def demos_p12(card: str) -> dict:
    """P12: the adaptation demo for 50 packets on the card, its feedback
    replayed into a CPU engine; the supervised demo with two workers on the
    card, one killed once."""
    def want(out):
        coded = sum(1 for fb in out["feedback"] if fb["header_valid"] and fb["inner_code"])
        return {"correlator": P12_PACKETS, "extract": P12_PACKETS, "recover": P12_PACKETS,
                "viterbi": coded, "halo": 0, "halo_wait": 0}

    (out, t_adapt), got = counted_by("P12 adaptation demo", lambda o: want(o[0]), lambda: wall(
        lambda: adaptation_demo.main(["--packets", str(P12_PACKETS)])))
    ref = CognitiveEngineBlock(ce_type="epsilon_greedy", seed=0)
    for i, (fb, dec) in enumerate(zip(out["feedback"], out["decisions"])):
        if ref.handler(fb) != dec:
            fail(f"P12 adaptation demo: a CPU engine fed the feedback decides otherwise at packet {i}")
    valid = sum(fb["payload_valid"] for fb in out["feedback"])
    print(f"P12 adaptation demo: {P12_PACKETS} packets, {valid} valid payloads, "
          f"{len({tuple(d.values()) for d in out['decisions']})} configs decided, "
          f"{P12_PACKETS / t_adapt:.1f} packets/s, a CPU engine fed the feedback decides alike; "
          f"launches {got} [{card}]")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "liquiddsp_tpu_torch.apps.supervised_rx_demo", "--workers", "2",
         "--chunks", "6", "--kill", "0"], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in proc.stdout.splitlines():
        if line.startswith(("worker", "total")):
            print("  " + line)
    if proc.returncode != 0 or "total: 12/12 frames decoded exactly once; restarts=[1, 0]" not in proc.stdout:
        fail(f"P12 supervised demo: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    print(f"P12 supervised demo on the card: 12/12 frames decoded exactly once, restarts=[1, 0], "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return {"P12 adaptation demo": got}


def main() -> None:
    t_start = time.perf_counter()
    card = card_line()
    print(f"device: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _cuda.lib()
    print(f"build: {len(_cuda.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s (set-up; "
          f"a library built earlier from the same sources is reused with its compiler log)")
    for chunk in _cuda.build_log:
        for line in chunk.splitlines():
            if "registers" in line or "==" in line or "spill" in line:
                print("  " + line.strip())
        # the Viterbi kernel keeps its metrics, the recover kernel its taps and
        # samples, in registers: neither may spill
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", chunk)]
        if chunk.startswith(("== viterbi.cu", "== recover.cu")) and (not spills or any(spills)):
            fail(f"register spills in {chunk.splitlines()[0]}: {spills}")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    streams = [tiled_stream(cfg, snr, BATCH, BLOCK, gen) for cfg, snr, _ in CONFIGS]
    sh_streams = [long_stream(cfg, snr, SH_BATCH, SH_TOTAL, gen) for cfg, snr, _ in CONFIGS]
    st_cfg, st_snr = CONFIGS[0][0], CONFIGS[0][1]
    st_stream = long_stream(st_cfg, st_snr, SH_BATCH, 3 * SH_TOTAL, gen)
    cl_streams = [tiled_stream(cfg, snr, CL_BATCH, BLOCK, gen) for cfg, snr in CLASS_CONFIGS]
    cl_sh_streams = [long_stream(cfg, snr, CL_SH_BATCH, CL_SH_TOTAL, gen) for cfg, snr in CLASS_CONFIGS]
    # P1-P4: the first block of each sweep (as config_space_loopback makes
    # it), the stretched stream, the mixed-config stream
    sweep_first = []
    for payload_len, mods in ((P1_PAYLOAD, None), (P2_PAYLOAD, [0])):
        cfgs = [c for c in ALL_CONFIGS if mods is None or c[0] in mods][:8]
        t_block = 2 * cs.slot_samples(payload_len) + cs.LEAD
        sweep_first.append(cs.loopback_block(cfgs, payload_len, 2, t_block,
                                             np.random.default_rng(0), DEV)[0])
    p3_stream = stretched_stream(P3_CFG, P3_SNR, P3_PPM, BATCH, BLOCK, gen)
    p4_cfgs, *p4_block = cs.mixed_stream(BATCH, BLOCK, P4_PAYLOAD, P4_SEED, DEV)
    p4_frames = p4_block[1].shape[1]
    # P5: the reference bench's streaming stream of each config; P6: one
    # generation of the loop with a random config on every channel
    p5_streams = [long_stream(cfg, snr, BATCH, P5_CHUNKS * BLOCK, gen) for cfg, snr, _ in CONFIGS]
    rng6 = np.random.default_rng(6)
    p6_cfgs = [ALL_CONFIGS[i] for i in rng6.integers(0, len(ALL_CONFIGS), BATCH)]
    p6_x = channel_block(p6_cfgs, rng6.integers(0, 256, (BATCH, P6_PAYLOAD), dtype=np.uint8),
                         P6_SNR, block_samples(P6_PAYLOAD), gen, DEV)
    # P8: the resampled receiver's streams and the blocks its receiver sees;
    # P10: a flowgraph block (FlexTx -> ChannelModel) at payload 32
    p8_streams = [resampled_stream(cfg, snr, BATCH, BLOCK, RESAMPLED_PPMS, gen, DEV)
                  for cfg, snr, _ in CONFIGS]
    p8_blocks = [resample_channels(st[0], st[4]) for st in p8_streams]
    p10_x = ChannelModel(20.0, seed=7, device=DEV).apply(
        FlexTx(1, 0, 0, device=DEV).send_pkt(np.zeros((1, 32), np.uint8)))
    torch.cuda.synchronize()

    # kernel shapes of the main path: the candidates the detector finds
    x_a, x_b = streams[0][0], streams[1][0]
    det_a = detector.detect(x_a, streams[0][3], fine=False)
    det_b = detector.detect(x_b, streams[1][3], fine=False)
    starts_a, starts_b = det_a.start.clone(), det_b.start.clone()
    starts_a[0, -1] = BLOCK - 50  # a window that runs past the end of the row
    spec_a, spec_b = fs.FrameSpec(CONFIGS[0][0]), fs.FrameSpec(CONFIGS[1][0])
    # the streams of the other paths, as their halo kernel sees them: the
    # streaming receiver's [carry | chunk | pad] window, the config classes'
    # 2 x 131,072
    st_window, st_k = streaming_shapes(st_cfg)
    ov_of = lambda cfg: fs.FrameSpec(cfg).frame_samples - 1
    syms_of = lambda cfg: fs.FrameSpec(cfg).frame_syms
    st_x = torch.nn.functional.pad(  # the window of the first step: a zero carry
        st_stream[0][:, :SH_TOTAL], (ov_of(st_cfg), st_window - SH_TOTAL - ov_of(st_cfg)))
    halo_also = [(st_x, SH_NTIME, ov_of(st_cfg))] + [
        (stream[0], CL_SH_NTIME, ov_of(cfg))
        for (cfg, _), stream in zip(CLASS_CONFIGS, cl_sh_streams)]
    kernels = [
        check_correlator(x_a, gen),
        check_extract(x_a, [(starts_a, spec_a.frame_samples), (starts_b, spec_b.frame_samples)]),
        check_recover(x_a, [(starts_a, spec_a.frame_syms), (starts_b, spec_b.frame_syms)], gen),
        check_viterbi(gen),
        check_halo(sh_streams[0][0], SH_NTIME, [ov_of(CONFIGS[0][0]), ov_of(CONFIGS[1][0])],
                   halo_also, gen),
    ]
    # the cross-process half at the block of P11's rank 1: the last half of
    # the sharded stream in 4 shards
    wait_entry, signal_checked = check_halo_order(
        sh_streams[0][0][:, SH_TOTAL // P11_RANKS[0]:].contiguous(), SH_NTIME // P11_RANKS[0],
        ov_of(CONFIGS[0][0]))
    kernels[-1]["also_checked"].append(signal_checked)
    kernels.append(wait_entry)
    # kernels 1-3 again at the shapes of every other path: the windows that
    # its halo kernel builds, seen as rows of the local receiver
    rows = lambda x, n_time, cfg: halo_windows(x, n_time, ov_of(cfg)).reshape(x.shape[0] * n_time, -1)
    for (cfg, _, _), stream in zip(CONFIGS, sh_streams):
        check_path_shapes(kernels, "sharded " + config_name(cfg), rows(stream[0], SH_NTIME, cfg),
                          syms_of(cfg), shard_slots(cfg, SH_TOTAL // SH_NTIME), gen)
    check_path_shapes(kernels, "streaming " + config_name(st_cfg), rows(st_x, SH_NTIME, st_cfg),
                      syms_of(st_cfg), st_k, gen)
    for (cfg, _), blk, sh in zip(CLASS_CONFIGS, cl_streams, cl_sh_streams):
        check_path_shapes(kernels, config_name(cfg), blk[0], syms_of(cfg), blk[3], gen)
        check_path_shapes(kernels, "sharded " + config_name(cfg), rows(sh[0], CL_SH_NTIME, cfg),
                          syms_of(cfg), shard_slots(cfg, CL_SH_TOTAL // CL_SH_NTIME), gen)
    # the self-describing receiver's and the SFO path's shapes: FlexRx blocks
    # at payload 32 (static) and 256 and 64 (SFO: no recover kernel), the
    # stretched stream (SFO, and static in the comparison run), and the
    # Viterbi kernel at every puncture and outer-code length those receivers
    # decode
    max_syms = lambda payload_len: fs.max_frame_spec(payload_len).frame_syms
    check_path_shapes(kernels, "P1 FlexRx payload 32", sweep_first[0], max_syms(P1_PAYLOAD), 4, gen)
    check_path_shapes(kernels, "P2 FlexRx payload 256 (SFO)", sweep_first[1], max_syms(P2_PAYLOAD),
                      4, gen, recover=False)
    check_path_shapes(kernels, "P3 framesync_fixed QAM16/1200", p3_stream[0], syms_of(P3_CFG),
                      p3_stream[3], gen)
    check_path_shapes(kernels, "P4 FlexRx payload 64 (SFO)", p4_block[0], max_syms(P4_PAYLOAD),
                      p4_frames + 2, gen, recover=False)
    for label, frames, payload_len in (("P1", 2, P1_PAYLOAD), ("P2", 2, P2_PAYLOAD),
                                       ("P4", p4_frames, P4_PAYLOAD), ("P6", BATCH, P6_PAYLOAD)):
        check_viterbi_shapes(kernels, label, frames, payload_len, gen)
    # P5: StreamingRx's windows [carry | chunk] = [64, 65,536 + overlap] with
    # the bench's slot count, the Viterbi kernel at that many frames; P6:
    # FlexRx blocks of the loop at payload 32 (static path), 2 slots a channel
    for (cfg, _, _), stream in zip(CONFIGS, p5_streams):
        ov, k5 = ov_of(cfg), shard_slots(cfg, BLOCK)
        check_path_shapes(kernels, "P5 StreamingRx " + config_name(cfg),
                          stream[0][:, BLOCK - ov : 2 * BLOCK].contiguous(), syms_of(cfg), k5, gen)
        if cfg.inner_code:
            check_viterbi_lam(kernels, "P5 StreamingRx " + config_name(cfg),
                              receiver_lam(BATCH * k5, cfg.payload_len, cfg.inner_code, cfg.outer_code, gen))
    check_path_shapes(kernels, "P6 loop FlexRx payload 32", p6_x, max_syms(P6_PAYLOAD), 2, gen)
    # P8: the resampled blocks with the bench's slot count; P9: the Viterbi
    # kernel over three candidates of 64 frames; P10: a flowgraph block, one
    # frame of every code at payload 32
    for (cfg, _, _), stream, y in zip(CONFIGS, p8_streams, p8_blocks):
        check_path_shapes(kernels, "P8 resampled " + config_name(cfg), y, syms_of(cfg), stream[3], gen)
    check_viterbi_lam(kernels, "P9 slip_retry " + config_name(P9_CFG),
                      receiver_lam(3 * P9_FRAMES, P9_CFG.payload_len, P9_CFG.inner_code,
                                   P9_CFG.outer_code, gen))
    check_path_shapes(kernels, "P10 flowgraph FlexRx payload 32", p10_x, max_syms(32), 8, gen)
    check_viterbi_shapes(kernels, "P10", 1, 32, gen)
    print(f"kernels: all six agree with their plain versions at the shapes of every path "
          f"({time.perf_counter() - t_start:.0f} s)")
    if "--kernels-only" in sys.argv[1:]:
        print(f"device: {card}")
        print(json.dumps({"kernels": kernels}))
        return

    # each path's step carries its own counts (``counted``). One
    # block-receiver step launches the correlator, extract and recover once
    # each, and the Viterbi kernel once where the config has the inner code;
    # a sharded or streaming step launches the halo kernel once besides.
    results, launches = [], {}
    for (cfg, _, _), (x, _, _, max_frames) in zip(CONFIGS, streams):
        res, got = counted(f"config {config_name(cfg)}", block_launches(cfg, 0),
                           lambda: framesync_fixed(x, cfg, max_frames))
        results.append(res)
        launches[config_name(cfg)] = got

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
    print(f"main path done ({time.perf_counter() - t_start:.0f} s)")

    for (cfg, snr, share), stream in zip(CONFIGS, sh_streams):
        launches["sharded " + config_name(cfg)] = sharded_step(cfg, snr, share, stream, card)
    del sh_streams, streams, results
    launches["streaming " + config_name(st_cfg)] = streaming_run(st_cfg, st_snr, st_stream, card)
    print(f"sharded path and streaming done ({time.perf_counter() - t_start:.0f} s)")
    for (cfg, snr), blk, sh in zip(CLASS_CONFIGS, cl_streams, cl_sh_streams):
        launches[config_name(cfg)], launches["sharded " + config_name(cfg)] = config_class_run(
            cfg, snr, blk, sh, card)
    del cl_streams, cl_sh_streams, st_stream
    print(f"config classes done ({time.perf_counter() - t_start:.0f} s)")

    launches["P1 config space payload 32"] = sweep_run(
        "P1 config space payload 32", P1_PAYLOAD, None, 8, card)
    print(f"P1 done ({time.perf_counter() - t_start:.0f} s)")
    launches["P2 long frames payload 256"] = sweep_run(
        "P2 long frames payload 256, BPSK", P2_PAYLOAD, [0], 4, card)
    print(f"P2 done ({time.perf_counter() - t_start:.0f} s)")
    launches.update(sfo_run(p3_stream, card))
    print(f"P3 done ({time.perf_counter() - t_start:.0f} s)")
    print(f"P4 configs, one a channel: {p4_cfgs}")
    launches.update(flexrx_run(p4_cfgs, p4_block, card))
    print(f"P4 done ({time.perf_counter() - t_start:.0f} s)")
    del p3_stream
    for (cfg, snr, share), stream in zip(CONFIGS, p5_streams):
        launches.update(streaming_p5(cfg, snr, share, stream, card))
    print(f"P5 done ({time.perf_counter() - t_start:.0f} s)")
    launches.update(programs_p13(p5_streams, p4_block, p6_x, card))
    del p5_streams, p4_block
    print(f"P13 done ({time.perf_counter() - t_start:.0f} s)")
    launches.update(loop_p6_p7(card))
    print(f"P6 and P7 done ({time.perf_counter() - t_start:.0f} s)")
    resampler_precisions(p8_streams[0][0], p8_streams[0][4], card)
    for (cfg, snr, share), stream in zip(CONFIGS, p8_streams):
        launches[f"P8 resampled {config_name(cfg)}"] = resampled_run(cfg, snr, share, stream, card)
    del p8_streams, p8_blocks
    print(f"P8 done ({time.perf_counter() - t_start:.0f} s)")
    launches.update(slip_retry_run(card))
    launches.update(flowgraph_run(card))
    print(f"P9 and P10 done ({time.perf_counter() - t_start:.0f} s)")
    p11_launches, p11_halo = distributed_p11(card)
    launches.update(p11_launches)
    halo_entry = next(k for k in kernels if k["name"] == "halo")
    halo_entry["also_checked"] += p11_halo["also_checked"]
    halo_entry["cross_process"] = p11_halo["cross_process"]
    print(f"P11 done ({time.perf_counter() - t_start:.0f} s)")
    launches.update(demos_p12(card))
    print(f"P12 done ({time.perf_counter() - t_start:.0f} s)")

    for k in kernels:
        k["launches_by_config"] = {label: d[k["name"]] for label, d in launches.items()}
        k["launches"] = sum(k["launches_by_config"].values())
        if k["launches"] < 1:
            fail(f"no path launched the {k['name']} kernel")
    for label, d in launches.items():
        print(f"launches, one step of {label}: {d}")
    st = program.STATS
    print(f"programs over the run (this process): {st['captures']} graphs captured in "
          f"{st['capture_s']:.1f} s (warm-up, capture and first replay), {st['replays']} replays, "
          f"graph pool {st['pool_bytes'] / 2**20:.0f} MiB, warm-up launches {st['warmup_launches']}")
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
