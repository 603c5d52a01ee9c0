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
"""

from __future__ import annotations

import numpy as np
import torch

from liquiddsp_tpu_torch.kernels import _cuda

KERNEL_F, KERNEL_L = 5, 128  # template bank shape compiled into the kernel


def _templates_tensor(templates, device: torch.device) -> torch.Tensor:
    if isinstance(templates, np.ndarray):
        templates = torch.from_numpy(templates.astype(np.complex64))
    return templates.to(device=device, dtype=torch.complex64).contiguous()


def _inv_template_energy(templates, inv_es: float | None) -> float:
    """1 / E_s. A caller that holds the templates on the device passes
    ``inv_es`` (known from the numpy template), so that no value has to come
    back from the device; numpy templates are summed on the host."""
    if inv_es is not None:
        return float(inv_es)
    if isinstance(templates, np.ndarray):
        return float(1.0 / np.sum(np.abs(templates[0].astype(np.complex64)) ** 2))
    return float(1.0 / torch.sum(torch.abs(templates[0]) ** 2).item())


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
    tm = _templates_tensor(templates, x.device)
    _cuda.check_cuda("templates", tm, torch.complex64, (KERNEL_F, KERNEL_L))
    inv_es = _inv_template_energy(templates, inv_es)
    rho2 = torch.empty((b, t), dtype=torch.float32, device=x.device)
    fbin = torch.empty((b, t), dtype=torch.int32, device=x.device)
    corr = torch.empty((b, t), dtype=torch.complex64, device=x.device)
    energy = torch.empty((b, t), dtype=torch.float32, device=x.device)
    _cuda.launch(
        "correlator", "lq_correlate_reduced", x.device,
        x.data_ptr(), tm.data_ptr(), rho2.data_ptr(), fbin.data_ptr(),
        corr.data_ptr(), energy.data_ptr(), b, t, inv_es,
    )
    return {"rho2": rho2, "fbin": fbin, "corr": corr, "energy": energy}
