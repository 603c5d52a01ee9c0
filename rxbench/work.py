"""The work a kernel's stage needs at a cell's shapes, and the H100's peaks.

Each function returns the least time in seconds in which one NVIDIA H100
SXM could do the stage: the larger of its operations over the peak rate
and its bytes over the memory bandwidth. Each input byte is counted as read
once and each output byte as written once, and the operations are those the
stage's algorithm needs, whichever kernel computes it. Peaks are NVIDIA's
published dense rates at the card's full 700 W limit.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # float32 on CUDA cores
PEAK_BF16_FLOPS = 989e12  # dense bf16 on tensor cores
# the correlator's float32-accurate product as bf16 tensor-core work: three
# products (hi x hi, hi x lo, lo x hi) of a split operand a float32 product
SPLIT_PRODUCTS = 3

N_TEMPLATES, TEMPLATE_LEN = 5, 128
V27_STATES = 64


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def correlator(rows: int, width: int) -> float:
    """Five 128-tap complex correlations and the window energy at every lag of
    [rows, width] complex64, reduced to rho2, bin, correlation and energy."""
    lags = rows * width
    nbytes = lags * 8 + N_TEMPLATES * TEMPLATE_LEN * 8 + lags * (4 + 4 + 8 + 4)
    # 5 x 128 complex multiply-adds a lag; the energy a sliding sum (about 4)
    flops = lags * (TEMPLATE_LEN * N_TEMPLATES * 8 + 4)
    return bound_s(nbytes, SPLIT_PRODUCTS * flops, PEAK_BF16_FLOPS)


def viterbi(frames: int, steps: int) -> float:
    """Add-compare-select over 64 states a step and traceback: LLR pairs in,
    one bit a step out."""
    nbytes = frames * steps * 8 + V27_STATES * 16 + frames * steps
    flops = frames * steps * V27_STATES * 8
    return bound_s(nbytes, flops, PEAK_F32_FLOPS)


def halo(rows: int, samples: int, n_time: int, window: int) -> float:
    """The shard windows [n_time, rows, window] complex64 cut from [rows,
    samples]: every sample read once, every window sample written once."""
    return bound_s(rows * samples * 8 + n_time * rows * window * 8, 0.0, PEAK_F32_FLOPS)


STAGES = {"correlator": correlator, "viterbi": viterbi, "halo": halo}
