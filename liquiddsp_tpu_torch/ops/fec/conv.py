"""K=7 convolutional code with puncturing + Viterbi decoding.

Counterpart of ``liquiddsp_tpu/ops/fec/conv.py``: CONV_V27 (rate 1/2,
constraint length 7) and punctured variants V27P{23,45,56,67,78}.

Spec:
- generator polynomials 0o133, 0o171 (the standard K=7 pair), MSB = oldest bit.
- encoder register ``reg = (state << 1) | u``; output bits
  c0 = parity(reg & G0), c1 = parity(reg & G1); next state = reg & 0x3F.
- terminated trellis: 6 zero tail bits appended, final state 0.
- puncturing: periodic keep-masks over the (c0, c1) streams; depuncturing
  inserts zero-LLR erasures.

The encoder is seven shifted XORs over the whole sequence. The decoder
depunctures and hands [B, steps, 2] LLR pairs to ``kernels.viterbi.viterbi``,
which runs the CUDA kernel on the GPU; ``_viterbi_run`` here is that kernel's
plain version and the decoder for CPU tensors. The segmented (approximate)
decoder of the JAX package is not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from liquiddsp_tpu_torch.core.device import device_const

G0 = 0o133  # 0b1011011
G1 = 0o171  # 0b1111001
K = 7
NSTATES = 64  # 2**(K-1)
NTAIL = K - 1

# puncture keep-masks per inner_code: ([c0 period], [c1 period]);
# index 1 = V27 (no puncturing)
PUNCTURE_PATTERNS: dict[int, tuple[tuple[int, ...], tuple[int, ...]]] = {
    1: ((1,), (1,)),  # rate 1/2
    2: ((1, 1), (1, 0)),  # rate 2/3
    3: ((1, 1, 1, 1), (1, 0, 0, 0)),  # rate 4/5
    4: ((1, 0, 1, 0, 1), (1, 1, 0, 1, 0)),  # rate 5/6
    5: ((1, 1, 1, 1, 1, 1), (1, 0, 0, 0, 0, 0)),  # rate 6/7
    6: ((1, 0, 0, 0, 1, 0, 1), (1, 1, 1, 1, 0, 1, 0)),  # rate 7/8
}

_PAR = np.array([bin(v).count("1") & 1 for v in range(128)], dtype=np.int8)


@functools.lru_cache(maxsize=None)
def _trellis_tables():
    """(out0[64,2], out1[64,2]) int8: expected coded bits for leaving
    ``state`` with input u."""
    out0 = np.zeros((NSTATES, 2), dtype=np.int8)
    out1 = np.zeros((NSTATES, 2), dtype=np.int8)
    for s in range(NSTATES):
        for u in range(2):
            reg = ((s << 1) | u) & 0x7F
            out0[s, u] = _PAR[reg & G0]
            out1[s, u] = _PAR[reg & G1]
    return out0, out1


@functools.lru_cache(maxsize=None)
def branch_signs() -> np.ndarray:
    """[64, 4] float32: per NEW state s' the LLR signs (e0_p0, e1_p0, e0_p1,
    e1_p1) of the two branches entering it, from predecessors p0 = s'>>1 and
    p1 = (s'>>1)|32 with input u = s'&1."""
    out0, out1 = _trellis_tables()
    sp = np.arange(NSTATES)
    p0 = sp >> 1
    p1 = (sp >> 1) | (NSTATES // 2)
    u = sp & 1
    return np.stack(
        [
            1.0 - 2.0 * out0[p0, u],
            1.0 - 2.0 * out1[p0, u],
            1.0 - 2.0 * out0[p1, u],
            1.0 - 2.0 * out1[p1, u],
        ],
        axis=1,
    ).astype(np.float32)


def num_coded_bits(nbits: int, inner_code: int) -> int:
    """Coded length (post-puncturing) for ``nbits`` message bits (+6 tail)."""
    if inner_code == 0:
        return nbits
    p0, p1 = PUNCTURE_PATTERNS[inner_code]
    period = len(p0)
    total_steps = nbits + NTAIL
    keep_per_period = sum(p0) + sum(p1)
    full, rem = divmod(total_steps, period)
    n = full * keep_per_period
    for i in range(rem):
        n += p0[i] + p1[i]
    return n


def _keep_mask(total_steps: int, inner_code: int) -> np.ndarray:
    """Interleaved keep mask [total_steps, 2] for (c0, c1)."""
    p0, p1 = PUNCTURE_PATTERNS[inner_code]
    period = len(p0)
    reps = -(-total_steps // period)
    m0 = np.tile(np.asarray(p0, dtype=bool), reps)[:total_steps]
    m1 = np.tile(np.asarray(p1, dtype=bool), reps)[:total_steps]
    return np.stack([m0, m1], axis=1)


def _keep_idx(steps: int, inner_code: int, device: torch.device) -> torch.Tensor:
    return device_const(
        ("conv_keep_idx", steps, inner_code),
        lambda: np.nonzero(_keep_mask(steps, inner_code).reshape(-1))[0].astype(np.int64),
        device,
    )


def encode_host(bits: np.ndarray, inner_code: int) -> np.ndarray:
    """[nbits] uint8 -> punctured coded bits (numpy oracle)."""
    if inner_code == 0:
        return bits.astype(np.uint8)
    msg = np.concatenate([bits, np.zeros(NTAIL, dtype=bits.dtype)])
    state = 0
    coded = []
    for u in msg:
        reg = ((state << 1) | int(u)) & 0x7F
        coded.append((_PAR[reg & G0], _PAR[reg & G1]))
        state = reg & 0x3F
    coded = np.asarray(coded, dtype=np.uint8)  # [steps, 2]
    return coded[_keep_mask(len(msg), inner_code)]


def encode(bits: torch.Tensor, inner_code: int) -> torch.Tensor:
    """bits [..., nbits] int8 -> coded [..., num_coded_bits] int8."""
    if inner_code == 0:
        return bits.to(torch.int8)
    nbits = bits.shape[-1]
    steps = nbits + NTAIL
    lead = bits.shape[:-1]
    zeros = torch.zeros(lead + (NTAIL,), dtype=torch.int32, device=bits.device)
    # padded[t .. t+6] = u_{t-6} .. u_t (6 zeros of initial state, 6 of tail)
    padded = torch.cat([zeros, bits.to(torch.int32), zeros], dim=-1)

    def code_bits(poly: int) -> torch.Tensor:
        acc = torch.zeros(lead + (steps,), dtype=torch.int32, device=bits.device)
        for tap in range(K):  # tap j (0 = oldest) <-> poly bit K-1-j
            if (poly >> (K - 1 - tap)) & 1:
                acc = acc ^ padded[..., tap : tap + steps]
        return acc

    coded = torch.stack([code_bits(G0), code_bits(G1)], dim=-1)  # [..., steps, 2]
    flat = coded.reshape(lead + (2 * steps,))
    return flat[..., _keep_idx(steps, inner_code, bits.device)].to(torch.int8)


def decode(llrs: torch.Tensor, nbits: int, inner_code: int) -> torch.Tensor:
    """Soft-input Viterbi: llrs [..., num_coded_bits] -> bits [..., nbits] int8.

    LLR convention: positive = bit 0 more likely (matches
    ops.modem.demod_soft_bits). Terminated trellis (start and end state 0).
    """
    from liquiddsp_tpu_torch.kernels.viterbi import viterbi

    if inner_code == 0:
        return (llrs[..., :nbits] < 0).to(torch.int8)
    batch_shape = llrs.shape[:-1]
    x = llrs.reshape((-1, llrs.shape[-1])).to(torch.float32)
    b = x.shape[0]
    steps = nbits + NTAIL
    # depuncture into [B, steps, 2] with zeros (erasures) at punctured slots
    full = torch.zeros((b, 2 * steps), dtype=torch.float32, device=x.device)
    full.index_copy_(1, _keep_idx(steps, inner_code, x.device), x)
    bits = viterbi(full.reshape(b, steps, 2))
    return bits[:, :nbits].reshape(batch_shape + (nbits,))


def decode_hard(bits: torch.Tensor, nbits: int, inner_code: int) -> torch.Tensor:
    """Hard-decision convenience wrapper: coded bits {0,1} -> message bits."""
    if inner_code == 0:
        return bits[..., :nbits].to(torch.int8)
    return decode(1.0 - 2.0 * bits.to(torch.float32), nbits, inner_code)


def _viterbi_run(lam: torch.Tensor) -> torch.Tensor:
    """Exact ACS + traceback over [B, steps, 2] erasure-padded LLRs -> bits
    [B, steps] int8, start and end state pinned to 0.

    Per step, for new state s': cand_i = (m[pred_i] + l0*e0_i) + l1*e1_i in
    that order, ``take1 = cand1 > cand0`` (a tie keeps the low-MSB
    predecessor), then the maximum over states is subtracted. The CUDA kernel
    repeats exactly these float32 operations, so the two agree bit for bit.
    """
    b, steps, _ = lam.shape
    dev = lam.device
    pred0 = device_const(("conv_pred0",), lambda: np.arange(NSTATES) >> 1, dev)
    pred1 = device_const(
        ("conv_pred1",), lambda: (np.arange(NSTATES) >> 1) | (NSTATES // 2), dev)
    e = device_const(("conv_branch_signs",), branch_signs, dev)
    e0_p0, e1_p0, e0_p1, e1_p1 = e[:, 0], e[:, 1], e[:, 2], e[:, 3]

    metrics = torch.full((b, NSTATES), -1e9, dtype=torch.float32, device=dev)
    metrics[:, 0] = 0.0
    decisions = torch.empty((steps, b, NSTATES), dtype=torch.bool, device=dev)
    for t in range(steps):
        l0 = lam[:, t, 0:1]
        l1 = lam[:, t, 1:2]
        cand0 = metrics[:, pred0] + l0 * e0_p0 + l1 * e1_p0
        cand1 = metrics[:, pred1] + l0 * e0_p1 + l1 * e1_p1
        take1 = cand1 > cand0
        metrics = torch.where(take1, cand1, cand0)
        metrics = metrics - torch.max(metrics, dim=1, keepdim=True).values
        decisions[t] = take1

    state = torch.zeros((b,), dtype=torch.int64, device=dev)
    bits = torch.empty((b, steps), dtype=torch.int8, device=dev)
    for t in range(steps - 1, -1, -1):
        d = torch.gather(decisions[t], 1, state[:, None])[:, 0]
        bits[:, t] = (state & 1).to(torch.int8)
        state = (state >> 1) | (d.to(torch.int64) * (NSTATES // 2))
    return bits
