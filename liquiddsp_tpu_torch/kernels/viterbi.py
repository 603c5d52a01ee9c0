"""Exact Viterbi decoding of the K=7 rate-1/2 code, 64 states, start and end
state 0.

``viterbi`` launches the CUDA kernel ``csrc/viterbi.cu`` for a CUDA tensor
(the counterpart of ``viterbi_pallas`` in ``liquiddsp_tpu/kernels/viterbi.py``)
and takes ``viterbi_ref`` only for a CPU tensor. The two agree bit for bit,
ties on erasures included: the kernel repeats the reference's float32
operations in the same order.

The kernel gives one warp to a frame and keeps the 64 path metrics in
registers, two per lane. Which state a register holds changes from step to
step with a period of 5 steps. The index arithmetic of that layout is written
here as small pure functions (``warp_state`` ... ``float_to_ordered``): the
wrapper builds the kernel's per-lane table of branch signs from them, the
``.cu`` source names them where it does the same arithmetic, and the CPU tests
run a numpy emulation of the warp's schedule built on them against
``viterbi_ref``.
"""

from __future__ import annotations

import numpy as np
import torch

from liquiddsp_tpu_torch.core.device import device_const
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.ops.fec import conv

LANES = 32
PHASES = 5  # the layout repeats every 5 trellis steps
TRACEBACK_BLOCK = 30  # steps the warp walks back per load: a multiple of PHASES, at most LANES


def _rotl5(v, k):
    k = k % PHASES
    return ((v << k) | (v >> (PHASES - k))) & 31


def _rotr5(v, k):
    return _rotl5(v, PHASES - k % PHASES)


def warp_state(lane, slot, phase):
    """The trellis state whose metric lane ``lane`` holds in register ``slot``
    (0 or 1) before a step of phase ``phase`` = t mod 5. Bit 5 of the state is
    the slot, so a lane always holds a pair (p, p + 32): the two predecessors
    of the states 2p and 2p + 1 (mod 64), which the lane computes alone. The
    low 5 bits are the lane's 5 bits rotated left by the phase."""
    return 32 * slot + _rotl5(lane, phase)


def warp_lane_slot(state, phase):
    """Inverse of ``warp_state``: (lane, slot) that hold ``state``."""
    return _rotr5(state & 31, phase), state >> 5


def exchange_mask(phase):
    """Lane mask of the one ``__shfl_xor_sync`` after a step of phase
    ``phase``. A lane has computed the new states 2q and 2q + 1 (mod 64), q
    its low state bits; their partners 2q + 32 and 2q + 33 were computed by
    the lane whose q differs in bit 4, which is bit (4 - phase) of the lane
    index. A lane with that bit clear keeps 2q and sends 2q + 1, a lane with
    it set keeps 2q + 1 and sends 2q, and each ends with a pair (p, p + 32)
    of the next phase's layout."""
    return 16 >> (phase % PHASES)


def decision_bit(state, phase):
    """(word, bit): where the traceback finds the decision of new state
    ``state`` made by a step of phase ``phase``. The step's two ballots are
    word 0 (the lanes' even new states 2q) and word 1 (the odd ones); the bit
    is the index of the lane that computed the state."""
    return state & 1, _rotr5(state >> 1, phase)


def traceback_pos(phase):
    """The traceback keeps the lane index L of ``decision_bit`` instead of the
    state. Stepping back from a step of phase ``phase`` replaces bit
    ``traceback_pos(phase)`` of L by the decision read, and the bit that was
    there is the word index (= the decoded bit) of the step before."""
    return (PHASES - phase % PHASES) % PHASES


def float_to_ordered(bits):
    """Order-preserving map from the bit pattern of a float32 (int32 array)
    to int32: ``a < b`` as floats iff ``map(a) < map(b)`` as integers (with
    -0.0 just below +0.0). It is its own inverse. The kernel takes the maximum
    of the 64 metrics with one integer ``redux.sync`` through this map."""
    bits = np.asarray(bits, dtype=np.int32)
    return bits ^ ((bits >> 31) & np.int32(0x7FFFFFFF))


ordered_to_float = float_to_ordered


def warp_signs() -> np.ndarray:
    """[5, 32, 8] float32: for phase k and lane l the branch signs of the two
    new states the lane computes, (e0_p0, e1_p0, e0_p1, e1_p1) of state 2q and
    then of state 2q + 1, q = ``warp_state(l, 0, k)``."""
    e = conv.branch_signs()
    out = np.empty((PHASES, LANES, 8), dtype=np.float32)
    for k in range(PHASES):
        q = warp_state(np.arange(LANES), 0, k)
        out[k, :, :4] = e[(2 * q) % conv.NSTATES]
        out[k, :, 4:] = e[(2 * q + 1) % conv.NSTATES]
    return out


def viterbi_ref(lam: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: lam [B, steps, 2] float32 -> bits [B, steps] int8."""
    return conv._viterbi_run(lam)


def viterbi(lam: torch.Tensor, stamps: torch.Tensor | None = None) -> torch.Tensor:
    """Depunctured LLR pairs lam [B, steps, 2] float32 (positive = bit 0) ->
    decoded bits [B, steps] int8 (the last 6 are the zero tail).

    ``stamps``, where given, is a [B, 3] int64 CUDA tensor into which each
    frame's warp writes its SM's ``clock64()`` at its start, after the forward
    pass and after the traceback."""
    if not lam.is_cuda:
        return viterbi_ref(lam)
    b, steps, _ = lam.shape
    _cuda.check_cuda("lam", lam, torch.float32, (b, steps, 2))
    if stamps is not None:
        _cuda.check_cuda("stamps", stamps, torch.int64, (b, 3))
    signs = device_const(("viterbi_warp_signs",), warp_signs, lam.device)
    # decision words of the steps, padded to whole periods of the layout
    dec_stride = -(-steps // PHASES) * PHASES
    dec = torch.empty((b, dec_stride), dtype=torch.int64, device=lam.device)
    bits = torch.empty((b, steps), dtype=torch.int8, device=lam.device)
    _cuda.launch(
        "viterbi", "lq_viterbi", lam.device,
        lam.data_ptr(), signs.data_ptr(), dec.data_ptr(), bits.data_ptr(),
        None if stamps is None else stamps.data_ptr(), b, steps, dec_stride,
    )
    return bits
