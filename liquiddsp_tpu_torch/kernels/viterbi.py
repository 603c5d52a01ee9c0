"""Exact Viterbi decoding of the K=7 rate-1/2 code, 64 states, start and end
state 0.

``viterbi`` launches the CUDA kernel ``csrc/viterbi.cu`` for a CUDA tensor
(the counterpart of ``viterbi_pallas`` in ``liquiddsp_tpu/kernels/viterbi.py``)
and takes ``viterbi_ref`` only for a CPU tensor. The two agree bit for bit,
ties on erasures included: the kernel repeats the reference's float32
operations in the same order.
"""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.core.device import device_const
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.ops.fec import conv


def viterbi_ref(lam: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: lam [B, steps, 2] float32 -> bits [B, steps] int8."""
    return conv._viterbi_run(lam)


def viterbi(lam: torch.Tensor) -> torch.Tensor:
    """Depunctured LLR pairs lam [B, steps, 2] float32 (positive = bit 0) ->
    decoded bits [B, steps] int8 (the last 6 are the zero tail)."""
    if not lam.is_cuda:
        return viterbi_ref(lam)
    b, steps, _ = lam.shape
    _cuda.check_cuda("lam", lam, torch.float32, (b, steps, 2))
    signs = device_const(("conv_branch_signs",), conv.branch_signs, lam.device)
    dec = torch.empty((b, steps), dtype=torch.int64, device=lam.device)
    bits = torch.empty((b, steps), dtype=torch.int8, device=lam.device)
    _cuda.launch(
        "viterbi", "lq_viterbi", lam.device,
        lam.data_ptr(), signs.data_ptr(), dec.data_ptr(), bits.data_ptr(), b, steps,
    )
    return bits
