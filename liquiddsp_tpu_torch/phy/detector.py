"""Batched preamble frame detector: the reference's frame_detector_cc /
liquid qdetector_cccf analog, block-dense.

Counterpart of ``liquiddsp_tpu/phy/detector.py``. A whole block [B, T] is
correlated at once:

1. cross-correlation of the block against F frequency-shifted copies of the
   128-sample pulse-shaped preamble template (multi-bin CFO tolerance), fused
   with the sliding signal energy and the reduction over bins
   (kernels/correlator.py);
2. normalized correlation rho^2[tau] = max_f |c_f[tau]|^2 / (E_s * E_x[tau]);
3. local-max suppression + threshold + top-K candidate extraction
   (fixed K: variable-rate detections as fixed slots + validity mask);
4. per-candidate estimates: tau_hat (fractional timing, parabolic interp),
   gamma_hat (gain), dphi_hat (CFO: coarse bin + fine dual-half phase slope),
   phi_hat (phase).

The FFT overlap-save correlator of the JAX package is not ported.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from liquiddsp_tpu_torch.core.device import device_const, resolve_device
from liquiddsp_tpu_torch.kernels.correlator import correlate_reduced
from liquiddsp_tpu_torch.kernels.extract import extract_windows
from liquiddsp_tpu_torch.ops import msequence, rrc
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.tables import PhyTables, phy_tables

TEMPLATE_LEN = fs.K_SAMP * fs.PREAMBLE_SYMS  # 128 samples
DEFAULT_THRESHOLD = 0.45
CFO_BINS = (-2, -1, 0, 1, 2)  # units of 2*pi/(2*TEMPLATE_LEN) rad/sample:
# adjacent bins overlap at ~3 dB


@functools.lru_cache(maxsize=None)
def template() -> np.ndarray:
    """The 128-sample pulse-shaped preamble template (data-independent
    prefix of every frame; see phy/frame_spec.py)."""
    pre = msequence.preamble_symbols()
    h = rrc.matched_taps()
    up = np.zeros(fs.K_SAMP * len(pre), dtype=np.complex64)
    up[:: fs.K_SAMP] = pre
    wave = np.convolve(up, h)
    return wave[:TEMPLATE_LEN].astype(np.complex64)


@functools.lru_cache(maxsize=None)
def templates_time() -> np.ndarray:
    """Frequency-shifted templates [F, TEMPLATE_LEN] complex64 (time domain)."""
    s = template()
    n = np.arange(TEMPLATE_LEN)
    bank = []
    for b in CFO_BINS:
        shift = np.exp(1j * 2.0 * np.pi * b * n / (2 * TEMPLATE_LEN))
        bank.append((s * shift).astype(np.complex64))
    return np.stack(bank).astype(np.complex64)


def cfo_of_bin(b: int) -> float:
    """Carrier offset (rad/sample) of CFO bin index b."""
    return 2.0 * np.pi * b / (2 * TEMPLATE_LEN)


TAU_BANK_PHASES = 16
TAU_BANK_RANGE = 12  # delayed-template rows cover +-12/16 = +-0.75 samples


@functools.lru_cache(maxsize=None)
def _delayed_templates() -> np.ndarray:
    """[2R+1, TEMPLATE_LEN] preamble templates fractionally delayed by
    (q - R)/TAU_BANK_PHASES samples: delay-matched references for fine_cfo.

    Correlating a window whose true timing offset is delta against the
    UNdelayed template biases the dual-half CFO slope by ~0.01*delta
    rad/sample; matching the template delay to the detector's tau estimate
    removes the bias to first order."""
    pre = msequence.preamble_symbols()
    rows = []
    for q in range(-TAU_BANK_RANGE, TAU_BANK_RANGE + 1):
        h = rrc.rrcos_taps(dt=q / TAU_BANK_PHASES)
        up = np.zeros(fs.K_SAMP * len(pre), dtype=np.complex64)
        up[:: fs.K_SAMP] = pre
        wave = np.convolve(up, h)
        rows.append(wave[:TEMPLATE_LEN])
    return np.stack(rows).astype(np.complex64)


@dataclasses.dataclass
class Detections:
    """Top-K frame-start candidates per batch row (fixed shapes + masks)."""

    mask: torch.Tensor  # [B, K] bool — candidate valid
    start: torch.Tensor  # [B, K] int32 — frame start sample index
    rho: torch.Tensor  # [B, K] float32 — normalized correlation amplitude
    gamma: torch.Tensor  # [B, K] float32 — gain estimate
    dphi: torch.Tensor  # [B, K] float32 — CFO estimate (rad/sample)
    phi: torch.Tensor  # [B, K] float32 — carrier phase at frame start
    tau: torch.Tensor  # [B, K] float32 — fractional timing (-0.5..0.5 samples)

    @classmethod
    def from_numpy(cls, d: dict[str, np.ndarray], device: torch.device | str | None = None):
        """Build from a dict of numpy arrays keyed by field name."""
        dev = resolve_device(device)
        return cls(**{
            f.name: torch.from_numpy(np.array(d[f.name])).to(dev)
            for f in dataclasses.fields(cls)
        })


def expj(theta: torch.Tensor) -> torch.Tensor:
    """e^{j theta} as complex64."""
    return torch.polar(torch.ones_like(theta), theta)


def fine_cfo(
    wins: torch.Tensor,
    coarse: torch.Tensor,
    tau: torch.Tensor | None = None,
    bank: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fine CFO from raw preamble windows [..., TEMPLATE_LEN]: derotate by
    the coarse (bin) estimate, then dual-half correlation phase slope against
    the row of ``bank`` (``_delayed_templates``; ``None``: built once for
    ``wins.device``) whose delay matches ``tau`` (the detector's
    fractional-timing estimate, samples). Without ``tau`` the plain template
    is the reference, and the estimate carries a ~0.01*tau rad/sample bias."""
    if tau is None:
        s = device_const(("fine_cfo_template",), template, wins.device)
    else:
        if bank is None:
            bank = phy_tables(None, wins.device).delayed_templates
        q = torch.clamp(
            torch.round(tau * TAU_BANK_PHASES).to(torch.int64), -TAU_BANK_RANGE, TAU_BANK_RANGE
        ) + TAU_BANK_RANGE
        s = bank[q]  # [..., TEMPLATE_LEN]
    half = TEMPLATE_LEN // 2
    n = torch.arange(TEMPLATE_LEN, dtype=torch.float32, device=wins.device)
    wins_d = wins * expj(-coarse[..., None] * n)
    c1 = torch.sum(wins_d[..., :half] * torch.conj(s[..., :half]), dim=-1)
    c2 = torch.sum(wins_d[..., half:] * torch.conj(s[..., half:]), dim=-1)
    return torch.angle(c2 * torch.conj(c1)) / half


def detect(
    x: torch.Tensor,
    max_frames: int,
    threshold: float = DEFAULT_THRESHOLD,
    min_spacing: int = TEMPLATE_LEN,
    fine: bool = True,
    return_count: bool = False,
    *,
    tables: PhyTables | None = None,
    device: torch.device | str | None = None,
):
    """Find up to ``max_frames`` preamble hits in [B, T] samples.

    Fixed output shapes; invalid slots are masked. Local-max suppression
    works on blocks of ``min_spacing`` samples: a peak must dominate its own
    block and both neighbors, an *effective* suppression radius between
    ``min_spacing`` and ``2 * min_spacing`` samples, so two frames must start
    more than ``2 * min_spacing`` apart to both be reported (frames are far
    longer than the default 128). ``fine=False`` skips the fine CFO refinement (dphi is then
    the coarse bin center): the framesync refines from its own frame windows
    instead of re-extracting preambles. ``return_count=True`` also returns the
    TOTAL threshold-passing peak count per row [B] int32 (before the top-K
    cut): a count above K means the top-K dropped real candidates.
    """
    dev = resolve_device(device)
    if tables is None:
        tables = phy_tables(None, dev)
    x = x.to(device=dev, dtype=torch.complex64).contiguous()
    b, t = x.shape
    es = float(np.sum(np.abs(template()) ** 2))
    red = correlate_reduced(x, tables.templates, inv_es=1.0 / es)
    energy = red["energy"]
    rho2 = torch.where(energy > 1e-9, red["rho2"], torch.zeros_like(energy))

    blk = min_spacing
    nb = -(-t // blk)
    rp = torch.nn.functional.pad(rho2, (0, nb * blk - t), value=-1.0)
    rb = rp.reshape(b, nb, blk)
    bm, am = torch.max(rb, dim=-1)  # block max, in-block offset (first max)
    ninf = torch.full((b, 1), float("-inf"), dtype=bm.dtype, device=dev)
    left = torch.cat([ninf, bm[:, :-1]], dim=1)
    right = torch.cat([bm[:, 1:], ninf], dim=1)
    is_peak = (bm >= left) & (bm >= right) & (bm > threshold * threshold)
    score = torch.where(is_peak, bm, torch.full_like(bm, -1.0))  # [B, nb]
    # top-K over blocks; ties (all non-peak blocks sit at -1) go to the
    # lowest index, which a stable descending sort gives and topk does not
    order = torch.sort(score, dim=-1, descending=True, stable=True)
    top_rho2, bstart = order.values[:, :max_frames], order.indices[:, :max_frames]
    mask = top_rho2 > 0
    start = bstart * blk + torch.gather(am, 1, bstart)
    start = torch.clamp(start, max=t - 1)  # int64 [B, K]

    # gather per-candidate quantities
    fbin = torch.gather(red["fbin"], 1, start).to(torch.int64)
    cpk = torch.gather(red["corr"], 1, start)
    epk = torch.gather(energy, 1, start)
    gamma = torch.sqrt(torch.clamp(epk, min=1e-12) / es)
    phi = torch.angle(cpk)

    # fractional timing: parabolic interpolation of rho2 around the peak
    t_idx = torch.clamp(start, 1, t - 2)
    ym = torch.gather(rho2, 1, t_idx - 1)
    y0 = torch.gather(rho2, 1, t_idx)
    yp = torch.gather(rho2, 1, t_idx + 1)
    denom = ym - 2 * y0 + yp
    tau = torch.where(
        torch.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom, torch.zeros_like(denom)
    )
    tau = torch.clamp(tau, -0.5, 0.5)

    # CFO: coarse (best bin) + optional fine (dual-half phase slope)
    coarse = device_const(
        ("cfo_bins",), lambda: np.array([cfo_of_bin(bb) for bb in CFO_BINS], np.float32), dev
    )[fbin]
    start = start.to(torch.int32)
    if fine:
        wins = extract_windows(x, start, TEMPLATE_LEN)
        dphi = coarse + fine_cfo(wins, coarse, tau, tables.delayed_templates)
    else:
        dphi = coarse
    det = Detections(
        mask=mask,
        start=start,
        rho=torch.sqrt(torch.clamp(top_rho2, min=0.0)),
        gamma=gamma.to(torch.float32),
        dphi=dphi.to(torch.float32),
        phi=phi.to(torch.float32),
        tau=tau.to(torch.float32),
    )
    if return_count:
        return det, torch.sum(is_peak.to(torch.int32), dim=-1, dtype=torch.int32)
    return det


def frame_detector_cc(
    x: torch.Tensor,
    max_frames: int = 16,
    threshold: float = DEFAULT_THRESHOLD,
    *,
    device: torch.device | str | None = None,
):
    """Stream-block API of the reference's frame_detector_cc (1-in/1-out
    passthrough + detection count): returns (passthrough, num_detected [B],
    detections)."""
    det = detect(x, max_frames, threshold, device=device)
    return x, torch.sum(det.mask.to(torch.int32), dim=-1, dtype=torch.int32), det
