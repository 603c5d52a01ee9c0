"""Fused multi-template preamble correlator (the hot loop of frame detection).

For every lag t it computes

    c_f[t] = sum_n x[t+n] * conj(s_f[n])        (F templates, L = 128 taps)
    E[t]   = sum_n |x[t+n]|^2
    rho2[t] = max_f |c_f[t]|^2 / (E_s * max(E[t], 1e-12))

and returns only the reduced per-lag quantities (rho2, first arg-max bin,
correlation at that bin, E); the [F, T] correlation surface never reaches
device memory. Samples past the end of a row count as zero.

``correlate_reduced`` launches the CUDA kernel ``csrc/correlator.cu`` for a
CUDA tensor (the counterpart of ``correlate_reduced_pallas`` in
``liquiddsp_tpu/kernels/correlator.py``) and takes ``correlate_reduced_ref``,
the plain PyTorch version of the same function, only for a CPU tensor.

The kernel runs the products on tensor cores, as one real matrix product a
tile: C [16, lags] = A [16, 2L] x H [2L, lags], where H is the Hankel matrix
of the signal's real and imaginary planes (column t holds x[t .. t+L-1]) and
A the templates' real form (``template_matrix``). Each operand is split into
bf16 hi + lo parts, and C = A_hi H_hi + A_hi H_lo + A_lo H_hi in float32.
Where the largest |c_f|^2 of a lag is within ``TIE`` of another, the kernel
sums those templates' correlations again in float32 on CUDA cores, so that
the bin is the float32 product's. The template side is built here (``template_fragments``), already in the
order of ``mma.sync.m16n8k16``'s A registers. The functions below that name
the kernel's index arithmetic are mirrored in the source, and the CPU tests
hold them against the instruction's operand layout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from liquiddsp_tpu_torch.core.device import device_const
from liquiddsp_tpu_torch.kernels import _cuda

KERNEL_F, KERNEL_L = 5, 128  # template bank shape compiled into the kernel
MMA_M, MMA_K = 16, 16  # mma.sync.m16n8k16: A is 16 rows by 16 of depth
IM_ROW = 8  # row f of A gives Re c_f, row f + IM_ROW gives Im c_f
KSTEPS = 2 * KERNEL_L // MMA_K  # 8 steps over the real plane, then 8 over the imaginary
TIE = 1.0 / 4096  # csrc/correlator.cu TIE: |c_f|^2 this close to the best are summed again


def _templates_tensor(templates, device: torch.device) -> torch.Tensor:
    if isinstance(templates, np.ndarray):
        templates = torch.from_numpy(templates.astype(np.complex64))
    return templates.to(device=device, dtype=torch.complex64).contiguous()


def _inv_template_energy(templates, inv_es: float | None) -> float:
    """1 / E_s. A caller that holds the templates on the device passes
    ``inv_es`` (known from the numpy template), so that no value has to come
    back from the device; numpy templates are summed on the host. The
    receiver's programs (``core.program``) always pass it: a captured call
    cannot read a value back."""
    if inv_es is not None:
        return float(inv_es)
    if isinstance(templates, np.ndarray):
        return float(1.0 / np.sum(np.abs(templates[0].astype(np.complex64)) ** 2))
    return float(1.0 / torch.sum(torch.abs(templates[0]) ** 2).item())


def template_matrix(tm: torch.Tensor) -> torch.Tensor:
    """[16, 2L] float32 real form of [5, L] complex templates, on their device.

    With the window's planes stacked as K = [Re x[t..t+L-1] | Im x[t..]],
    x conj(s) = (a sr + b si) + j (b sr - a si) gives row f = [sr_f | si_f]
    (Re c_f) and row f + 8 = [-si_f | sr_f] (Im c_f). Rows 5-7 and 13-15 are
    zero: a thread of the product holds rows g and g + 8 of its columns, so
    each complex c_f lands whole in one thread."""
    f, l = tm.shape
    sr, si = tm.real.to(torch.float32), tm.imag.to(torch.float32)
    m = torch.zeros((MMA_M, 2 * l), dtype=torch.float32, device=tm.device)
    m[:f, :l], m[:f, l:] = sr, si
    m[IM_ROW : IM_ROW + f, :l], m[IM_ROW : IM_ROW + f, l:] = -si, sr
    return m


def split_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo) bf16 with hi = bf16(a) and lo = bf16(a - hi), both
    rounded to nearest even, as the kernel splits its signal tile
    (``__float2bfloat16_rn``). a - hi is exact in float32, and hi + lo
    carries 16 significant bits."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.to(torch.float32)).to(torch.bfloat16)


def a_fragment_index() -> tuple[np.ndarray, np.ndarray]:
    """Where the kernel's A registers come from: element e (0-7) of lane l's
    four 32-bit A registers at k-step s holds A[rows[l, e], cols[s, l, e]].

    ``mma.sync.m16n8k16`` (bf16, row-major A): register r holds two values
    (e = 2r in the low half) of row g + 8 (r & 1) and columns
    2 tid + (e & 1) + 8 (r >> 1), with g = l >> 2 and tid = l & 3. K-step s
    covers columns 16 s .. 16 s + 15."""
    lane = np.arange(32)[:, None]
    e = np.arange(8)[None, :]
    g, tid, reg, half = lane >> 2, lane & 3, e >> 1, e & 1
    rows = g + IM_ROW * (reg & 1)
    cols0 = 2 * tid + half + 8 * (reg >> 1)
    cols = MMA_K * np.arange(KSTEPS)[:, None, None] + cols0[None]
    return rows, cols


def template_fragments(tm: torch.Tensor) -> torch.Tensor:
    """[2, KSTEPS, 32, 8] bf16 on ``tm``'s device: the split template matrix
    (hi, then lo) in the order in which each lane loads its A registers, 16
    bytes a lane and k-step. This is the kernel's template operand."""
    hi, lo = split_bf16(template_matrix(tm))
    rows = device_const(("a_fragment_rows",), lambda: a_fragment_index()[0], tm.device)
    cols = device_const(("a_fragment_cols",), lambda: a_fragment_index()[1], tm.device)
    return torch.stack([hi[rows[None], cols], lo[rows[None], cols]]).contiguous()


def b_fragment_word(q, lane) -> tuple[np.ndarray, np.ndarray]:
    """Where a lane reads its B register for signal position ``q``.

    B's column n (a lag) at depth k is x[t + n + k]. Register b0 of the tile
    of lags t .. t+7 at k-step j holds x[base + g + 2 tid] and the sample after
    it (base = t + 16 j, a multiple of 8, at position q = base / 8); b1 holds
    the pair 8 samples on, which is b0 of position q + 1. For an odd g the pair
    starts on an odd sample, so it is read from the copy of the plane shifted
    by one sample (copy[u] = x[u + 1]), where it starts on an even one.
    Returns (copy 0 or 1, index of the 32-bit word in that copy), positions
    counted from the warp's first lag."""
    g, tid = np.asarray(lane) >> 2, np.asarray(lane) & 3
    return g & 1, 4 * np.asarray(q) + (g >> 1) + tid


def correlate_reduced_ref(
    x: torch.Tensor, templates, inv_es: float | None = None
) -> dict[str, torch.Tensor]:
    """Plain PyTorch version: sliding windows x complex product, in float32.

    x [B, T] complex64, templates [F, L] complex -> dict of [B, T] tensors:
    rho2 (f32), fbin (int32), corr (complex64), energy (f32)."""
    inv_es = _inv_template_energy(templates, inv_es)
    tm = _templates_tensor(templates, x.device)
    f, l = tm.shape
    b, t = x.shape
    xp = torch.nn.functional.pad(x.to(torch.complex64), (0, l - 1))
    tc = torch.conj(tm).T.contiguous()  # [L, F]
    rows_per = max(1, (1 << 27) // (t * l))  # bound the unfolded copy
    outs = {"rho2": [], "fbin": [], "corr": [], "energy": []}
    for r0 in range(0, b, rows_per):
        win = xp[r0 : r0 + rows_per].unfold(-1, l, 1)  # [r, T, L] view
        c = win @ tc  # [r, T, F]
        en = torch.sum(win.real**2 + win.imag**2, dim=-1)
        mag2 = c.real**2 + c.imag**2
        best, fb = torch.max(mag2, dim=-1)  # first maximum wins
        outs["rho2"].append(best * inv_es / torch.clamp(en, min=1e-12))
        outs["fbin"].append(fb.to(torch.int32))
        outs["corr"].append(torch.gather(c, -1, fb[..., None])[..., 0])
        outs["energy"].append(en)
    return {k: torch.cat(v, dim=0) for k, v in outs.items()}


def correlate_reduced(
    x: torch.Tensor, templates, inv_es: float | None = None
) -> dict[str, torch.Tensor]:
    """x [B, T] complex64, templates [5, 128] complex -> dict of [B, T]
    tensors rho2, fbin (int32), corr (complex64), energy. ``inv_es`` is
    1 / sum |templates[0]|^2 where the caller knows it already."""
    if not x.is_cuda:
        return correlate_reduced_ref(x, templates, inv_es)
    b, t = x.shape
    _cuda.check_cuda("x", x, torch.complex64, (b, t))
    if b > 65535:  # rows ride on gridDim.y
        raise ValueError(f"x: at most 65535 rows per call, got {b}")
    tm, frags = _operands_on(templates, x.device)
    inv_es = _inv_template_energy(templates, inv_es)
    rho2 = torch.empty((b, t), dtype=torch.float32, device=x.device)
    fbin = torch.empty((b, t), dtype=torch.int32, device=x.device)
    corr = torch.empty((b, t), dtype=torch.complex64, device=x.device)
    energy = torch.empty((b, t), dtype=torch.float32, device=x.device)
    _cuda.launch(
        "correlator", "lq_correlate_reduced", x.device,
        x.data_ptr(), tm.data_ptr(), frags.data_ptr(), rho2.data_ptr(), fbin.data_ptr(),
        corr.data_ptr(), energy.data_ptr(), b, t, inv_es,
    )
    return {"rho2": rho2, "fbin": fbin, "corr": corr, "energy": energy}


# the kernel's template operands built for a bank: by the bytes of a numpy
# bank, by the tensor (and its in-place version) of a tensor bank, per device
_OPERANDS_NP: dict[tuple, tuple] = {}
_OPERANDS_T = WeakIdKeyDictionary()


def _operands(templates, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    if tuple(templates.shape) != (KERNEL_F, KERNEL_L):
        raise ValueError(f"templates: expected shape {(KERNEL_F, KERNEL_L)}, got {tuple(templates.shape)}")
    tm = _templates_tensor(templates, device)
    return tm, template_fragments(tm)


def _operands_on(templates, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The bank as complex64 on ``device`` (the kernel sums near-ties again
    in float32 from it) and its ``template_fragments``, built at the bank's
    first call and reused, so that a call launches the kernel and nothing
    else."""
    if isinstance(templates, np.ndarray):
        a = np.ascontiguousarray(templates, dtype=np.complex64)
        key = (a.tobytes(), a.shape, str(device))
        if key not in _OPERANDS_NP:
            if len(_OPERANDS_NP) >= 16:
                _OPERANDS_NP.pop(next(iter(_OPERANDS_NP)))
            _OPERANDS_NP[key] = _operands(a, device)
        return _OPERANDS_NP[key]
    per = _OPERANDS_T.setdefault(templates, {})
    key = (templates._version, str(device))
    if key not in per:
        per.clear()
        per[key] = _operands(templates, device)
    return per[key]
