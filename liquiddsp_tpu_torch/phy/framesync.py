"""Frame synchronizer (RX): the reference's flex_rx / liquid flexframesync
analog, block-dense.

Counterpart of ``liquiddsp_tpu/phy/framesync.py``. A whole block [B, T] is
processed at once:

1. dense preamble detection over the block (phy/detector.py) -> top-K
   candidate frame starts with tau/gamma/dphi/phi estimates;
2. per-candidate frame extraction (kernels/extract.py);
3. NCO derotation + gain normalization + matched filter with a
   fractional-delay RRC bank (timing recovery) + k=2 decimation
   (kernels/recover.py) -> symbol estimates;
4. two-stage linear equalizer, carrier fit, header demod (QPSK) -> Golay
   decode -> CRC24 -> header_valid + config fields;
5. payload carrier tracking, soft demod -> deinterleave -> inner (Viterbi,
   kernels/viterbi.py) -> outer decode -> CRC24 -> payload_valid.

All shapes are fixed: [B, K] frame slots with validity masks.

Frames of ``SFO_AUTO_SYMS`` symbols and more (and any frame with
``track_sfo=True``) take the sample-clock-drift (SFO) path in place of step 3:
complex windows, a decision-free fit of the sampling-instant trajectory over
64-symbol segments, and a per-segment fractional-delay matched filter.

``framesync_fixed`` decodes payloads assuming one (mod, fec) config: the
block receiver. ``sync_common`` (steps 1-4) and ``decode_payload_symbols``
(step 5) are the two halves that the self-describing receiver
(runtime/blocks.FlexRx) composes with a payload config read from each
header. Not ported, and absent from the signatures: the ablation hooks.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import device_const, resolve_device
from liquiddsp_tpu_torch.kernels.extract import extract_windows
from liquiddsp_tpu_torch.kernels.recover import recover_symbols_planes
from liquiddsp_tpu_torch.ops import bits as bitops
from liquiddsp_tpu_torch.ops import crc, modem, msequence, rrc
from liquiddsp_tpu_torch.ops.fec import registry
from liquiddsp_tpu_torch.ops.fec.block import golay2412
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.detector import (
    TEMPLATE_LEN,
    Detections,
    detect,
    expj,
    fine_cfo,
)
from liquiddsp_tpu_torch.phy.framegen import header_bytes_to_symbols
from liquiddsp_tpu_torch.phy.tables import PhyTables, phy_tables

NUM_TIMING_PHASES = 32
SFO_SEG = 64  # symbols per timing-tracking segment
SFO_AUTO_SYMS = 2200  # track sample-clock drift on frames this long and longer


@dataclasses.dataclass
class FrameResults:
    """Per-candidate decode results, [B, K] slots (masked)."""

    mask: torch.Tensor  # [B, K] bool — detection valid
    header_valid: torch.Tensor  # [B, K] bool — header CRC passed
    payload_valid: torch.Tensor  # [B, K] bool — payload CRC passed
    modulation: torch.Tensor  # [B, K] int32 — from decoded header
    inner_code: torch.Tensor  # [B, K] int32
    outer_code: torch.Tensor  # [B, K] int32
    payload_len: torch.Tensor  # [B, K] int32
    header_user: torch.Tensor  # [B, K, 14] uint8
    payload: torch.Tensor  # [B, K, payload_len] uint8
    symbols: torch.Tensor  # [B, K, n_syms] complex64 — the constellation port
    evm: torch.Tensor  # [B, K] float32 — header-symbol EVM (dB)
    rssi: torch.Tensor  # [B, K] float32 — estimated gain (dB)
    cfo: torch.Tensor  # [B, K] float32 — carrier offset estimate (rad/sample)
    start: torch.Tensor  # [B, K] int32 — frame start sample
    # host-side 2^30 base of ``start`` for long streams: absolute sample
    # index = epoch + start. Always 0 out of the receivers themselves; the
    # streaming wrappers stamp the true value on each result they return.
    epoch: int = 0

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Every field as a numpy array on the host."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return out


# ---------------------------------------------------------------------------
# candidate extraction + symbol recovery
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _timing_bank30() -> np.ndarray:
    """Reversed 30-tap fractional-delay bank indexed by q = round(tau*P)+P/2.

    Folds the integer base shift for negative tau into the filter itself
    (one zero pad position), so symbol recovery needs no per-candidate
    offsets: sym[s] = sum_v win[2s+v] * bank30[q, v]. bank30[q] is the
    time-reversed bank[p] (p = q - P/2, wrapped as in the classic convolve
    formulation) placed at offset ``base``.
    """
    p_half = NUM_TIMING_PHASES // 2
    bank = rrc.fractional_delay_bank(NUM_TIMING_PHASES)  # [P, 29]
    out = np.zeros((NUM_TIMING_PHASES + 1, fs.PULSE_LEN + 1), dtype=np.float32)
    for q in range(NUM_TIMING_PHASES + 1):
        p = q - p_half
        base = 1 if p < 0 else 0
        pp = p + NUM_TIMING_PHASES if p < 0 else p
        out[q, base : base + fs.PULSE_LEN] = bank[pp][::-1]
    return out


@functools.lru_cache(maxsize=None)
def _timing_bank65() -> np.ndarray:
    """Extended fractional-delay bank covering a +-1.0-sample range for
    symbol-timing (SFO) tracking: row q samples the matched-filter output at
    nominal + (q - P)/P samples, q in [0, 2P].

    Same construction as _timing_bank30 but with the integer sample shift
    folded over a 3-position base range, and a global +1 placement so the
    caller reads the window with a one-sample front pad:
    y[s] = sum_v winp[2s+v] * bank65[q, v], winp = [0, win...].
    """
    p_half = NUM_TIMING_PHASES
    bank = rrc.fractional_delay_bank(NUM_TIMING_PHASES)  # [P, 29]
    W = fs.PULSE_LEN + 3  # 32 taps (last tap always zero)
    out = np.zeros((2 * p_half + 1, W), dtype=np.float32)
    for q in range(2 * p_half + 1):
        p = q - p_half  # sampling offset p/P in [-1, 1]
        a = int(np.floor(p / p_half))  # integer sample shift {-1, 0, 1}
        pp = p - a * p_half  # fractional phase in [0, P)
        base = 1 - a  # {0, 1, 2}
        out[q, base : base + fs.PULSE_LEN] = bank[pp][::-1]
    return out


def _prototype_taps30() -> np.ndarray:
    """The symmetric matched filter as one 30-tap row (no timing correction)."""
    t30 = np.zeros(fs.PULSE_LEN + 1, dtype=np.float32)
    t30[: fs.PULSE_LEN] = rrc.matched_taps()[::-1]
    return t30


def _candidate_taps30(det: Detections, bank30: torch.Tensor, timing_bank: bool = True) -> torch.Tensor:
    """Per-candidate 30-tap matched-filter rows [B, K, 30]: the detector's
    tau is "signal arrives tau samples late", so sampling on the fixed even
    decimation grid must be *advanced* by tau, which the bank's
    delay-indexed rows express as row -tau. ``timing_bank=False`` gives every
    candidate the symmetric prototype."""
    if not timing_bank:
        proto = device_const(("mf_proto30",), _prototype_taps30, bank30.device)
        return proto.expand(det.start.shape + proto.shape).contiguous()
    p_half = NUM_TIMING_PHASES // 2
    q = torch.clamp(
        torch.round(-det.tau * NUM_TIMING_PHASES).to(torch.int64), -p_half, p_half
    ) + p_half
    return bank30[q]


def _recover_planes(wr, wi, det: Detections, n_syms: int, tables: PhyTables,
                    timing_bank: bool) -> torch.Tensor:
    """Derotation, gain normalisation, matched filter and decimation of window
    planes [B, K, n] by the recover kernel -> symbols [B, K, n_syms]."""
    return recover_symbols_planes(
        wr, wi, det.dphi.contiguous(), det.phi.contiguous(), det.gamma.contiguous(),
        _candidate_taps30(det, tables.timing_bank30, timing_bank), n_syms,
    )


def extract_symbols(
    x: torch.Tensor, det: Detections, n_syms: int, timing_bank: bool = True,
    *, tables: PhyTables | None = None,
) -> torch.Tensor:
    """Recover [B, K, n_syms] symbol estimates of each candidate frame of
    ``x`` [B, T] on the static path: extract the windows at the detected
    starts (kernels/extract.py), then ``symbols_from_windows``."""
    n_samples = fs.K_SAMP * n_syms + fs.PULSE_TAIL
    wr, wi = extract_windows(x, det.start, n_samples, return_planes=True)
    if tables is None:
        tables = phy_tables(None, x.device)
    return _recover_planes(wr, wi, det, n_syms, tables, timing_bank)


def symbols_from_windows(
    win: torch.Tensor, det: Detections, n_syms: int, timing_bank: bool = True,
    *, tables: PhyTables | None = None,
) -> torch.Tensor:
    """Candidate windows [B, K, 2*n_syms + PULSE_TAIL] complex64 -> symbol
    estimates [B, K, n_syms] on the static path (one fractional delay per
    frame). ``timing_bank=False`` gives every candidate the symmetric
    prototype instead of its delay row."""
    if tables is None:
        tables = phy_tables(None, win.device)
    return _recover_planes(win.real.contiguous(), win.imag.contiguous(), det, n_syms,
                           tables, timing_bank)


def _derotate_window(win: torch.Tensor, det: Detections) -> torch.Tensor:
    """NCO derotation + gain normalization of candidate windows [B, K, S].

    The rotation exp(-j(dphi*n+phi)) is built as a coarse x fine outer
    product: 2 complex multiplies per sample instead of one transcendental."""
    n_samples = win.shape[-1]
    fine_n = 32
    n_coarse = -(-n_samples // fine_n)
    dev = win.device
    nf = torch.arange(fine_n, dtype=torch.float32, device=dev)
    ncs = torch.arange(n_coarse, dtype=torch.float32, device=dev) * fine_n
    e_fine = expj(-(det.dphi[..., None] * nf))  # [B, K, fine]
    e_coarse = expj(-(det.dphi[..., None] * ncs + det.phi[..., None]))  # [B, K, coarse]
    nco = (e_coarse[..., :, None] * e_fine[..., None, :]).reshape(
        det.start.shape + (n_coarse * fine_n,)
    )[..., :n_samples]
    return win * nco / torch.clamp(det.gamma[..., None], min=1e-9)


def _segment_windows(win_d: torch.Tensor, nseg: int, seg: int) -> torch.Tensor:
    """The 32-sample input windows of every output symbol of every segment,
    as float32 planes [2 (real, imag), ..., nseg, seg, 32]:
    out[p, ..., s, j, v] = winp[2*seg*s + 2*j + v], winp = [0, win_d, 0...].

    Segment s reads winp[2*seg*s : 2*seg*s + 2*seg + 30]; the pad at the end
    only reaches where the last segment runs past the window, which is never
    cut. One product with the taps then filters and decimates all segments."""
    L = 2 * seg + 30
    need = 2 * seg * (nseg - 1) + L
    planes = torch.stack([win_d.real, win_d.imag])  # [2, ..., S]
    planes = torch.nn.functional.pad(planes, (1, max(0, need - win_d.shape[-1] - 1)))
    segw = planes.unfold(-1, L, 2 * seg)[..., :nseg, :]  # [2, ..., nseg, L]
    return segw.unfold(-1, 32, 2).contiguous()  # [2, ..., nseg, seg, 32]


def _segment_recover(windows: torch.Tensor, taps: torch.Tensor, n_syms: int) -> torch.Tensor:
    """Per-segment polyphase matched filter + k=2 decimation:
    y[s*seg + j] = sum_v windows[..., s, j, v] * taps[..., s, v].

    ``windows`` from _segment_windows; ``taps`` [..., nseg, 32] the
    _timing_bank65 row of each segment (its tracked sampling instant).
    Returns [..., n_syms] complex64."""
    y = torch.matmul(windows, taps[..., :, :, None])[..., 0]  # [2, ..., nseg, seg]
    y = torch.complex(y[0], y[1])
    return y.reshape(y.shape[:-2] + (-1,))[..., :n_syms]


_SFO_DELTAS = (-0.5, -0.25, 0.0, 0.25, 0.5)  # trial offsets, samples


def _sfo_fit(windows: torch.Tensor, tau: torch.Tensor, seg: int, bank65: torch.Tensor) -> torch.Tensor:
    """Estimate the per-segment sampling-instant trajectory u(s) = a + b*s
    (residual timing offset + sample-clock drift) and return bank65 rows
    [B, K, nseg].

    Decision-free power metric: the matched-filter output power over a
    segment peaks at the correct sampling instant (the RRC timing tone,
    beta=0.3). Five trial offsets spanning +-0.5 sample are filtered in one
    product; a per-segment parabolic vertex around the best trial gives u_s,
    and a contrast-weighted least-squares line over segments smooths it into
    the (offset, drift) model. The fitted drift is clipped to +-100 ppm so a
    noise-floor fit can never do worse than the static path by more than a
    bank step or two.
    """
    P = NUM_TIMING_PHASES
    nseg = windows.shape[-3]
    deltas = device_const(("sfo_deltas",), lambda: np.array(_SFO_DELTAS, np.float32), tau.device)
    q = torch.clamp(torch.round((-tau[..., None] + deltas) * P).to(torch.int64), -P, P) + P
    taps = bank65[q].transpose(-1, -2)  # [B, K, 32, 5]
    y = torch.matmul(windows, taps[..., None, :, :])  # [2, B, K, nseg, seg, 5]
    M = torch.sum(torch.abs(torch.complex(y[0], y[1])) ** 2, dim=-2)  # [B, K, nseg, 5]

    jbest = torch.clamp(torch.argmax(M, dim=-1), 1, 3)  # interior for the parabola
    take = lambda off: torch.gather(M, -1, (jbest + off)[..., None])[..., 0]
    m_lo, m_0, m_hi = take(-1), take(0), take(1)
    denom = m_lo - 2.0 * m_0 + m_hi
    vert = 0.125 * (m_lo - m_hi) / torch.where(
        torch.abs(denom) > 1e-20, denom, torch.ones_like(denom))
    vert = torch.clamp(vert, -0.125, 0.125)
    u_s = -tau[..., None] + _SFO_DELTAS[1] + 0.25 * (jbest - 1).to(torch.float32) + vert

    # contrast-weighted LS line u(s) = a + b*s over segments
    w = torch.clamp(torch.amax(M, dim=-1) - torch.amin(M, dim=-1), min=0.0) ** 2
    s_idx = torch.arange(nseg, dtype=torch.float32, device=tau.device)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-20)
    s_bar = torch.sum(w * s_idx, dim=-1) / wsum
    u_bar = torch.sum(w * u_s, dim=-1) / wsum
    ds = s_idx - s_bar[..., None]
    var = torch.clamp(torch.sum(w * ds**2, dim=-1), min=1e-20)
    b = torch.sum(w * ds * u_s, dim=-1) / var
    b = torch.clamp(b, -2e-4 * 2 * seg, 2e-4 * 2 * seg)  # +-100 ppm drift cap
    a = u_bar - b * s_bar
    u_fit = a[..., None] + b[..., None] * s_idx
    return torch.clamp(torch.round(u_fit * P).to(torch.int64), -P, P) + P


def _sfo_recover(win: torch.Tensor, det: Detections, n_syms: int, bank65: torch.Tensor,
                 seg: int = SFO_SEG) -> torch.Tensor:
    """Symbol recovery with sample-clock-drift (SFO) tracking: estimate the
    sampling-instant trajectory across the frame and matched-filter each
    segment at its own fractional delay. The static per-frame tau drifts off
    by >0.1 sample beyond ~2500 symbols at 50 ppm."""
    win_d = _derotate_window(win, det)
    nseg = -(-n_syms // seg)
    windows = _segment_windows(win_d, nseg, seg)
    q_seg = _sfo_fit(windows, det.tau, seg, bank65)
    return _segment_recover(windows, bank65[q_seg], n_syms)


def recover_candidates(
    x: torch.Tensor, det: Detections, n_syms: int, tables: PhyTables,
    timing_bank: bool = True, track_sfo: bool = False, fine: bool = True,
) -> tuple[Detections, torch.Tensor]:
    """Stages 2-3: one window extraction serves both the fine CFO estimate
    (from the preamble prefix of each frame window, skipped with
    ``fine=False``) and symbol recovery. The static path reads the windows as
    float32 planes into the recover kernel; ``track_sfo`` takes the SFO path
    on complex windows. Returns (det with refined dphi, symbols [B, K,
    n_syms])."""
    n_samples = fs.K_SAMP * n_syms + fs.PULSE_TAIL
    start = det.start.to(torch.int32).contiguous()
    if track_sfo:
        win = extract_windows(x, start, n_samples)
        if fine:
            det = dataclasses.replace(det, dphi=det.dphi + fine_cfo(
                win[..., :TEMPLATE_LEN], det.dphi, det.tau, tables.delayed_templates))
        return det, _sfo_recover(win, det, n_syms, tables.timing_bank65)
    wr, wi = extract_windows(x, start, n_samples, return_planes=True)
    if fine:
        pre = torch.complex(wr[..., :TEMPLATE_LEN], wi[..., :TEMPLATE_LEN])
        det = dataclasses.replace(det, dphi=det.dphi + fine_cfo(
            pre, det.dphi, det.tau, tables.delayed_templates))
    return det, _recover_planes(wr, wi, det, n_syms, tables, timing_bank)


# ---------------------------------------------------------------------------
# header decode
# ---------------------------------------------------------------------------


def decode_header_multi(regions: list[torch.Tensor]):
    """Decode W candidate header streams ([..., 180] each) in one pass:
    returns ((header_valid, user_bytes[..., W, 14], payload_len, modulation,
    inner, outer), hdr_bytes[..., W, 22]) with a [..., W] branch axis.

    The branches are concatenated on the symbol axis; 180 symbols = 15 Golay
    blocks exactly, so block boundaries never straddle a branch seam."""
    w = len(regions)
    cat = torch.cat(regions, dim=-1)  # [..., W*180]
    idx = modem.demod_hard(cat, fs.HEADER_MOD)
    coded = modem.indices_to_bits(idx, 2)  # [..., W*360]
    bits = golay2412().decode(coded)  # [..., W*180] data bits
    per = fs.HEADER_SYMS  # 180 data bits per branch (15 blocks x 12)
    hdr = torch.stack(
        [
            bitops.bits_to_bytes(bits[..., b * per : b * per + fs.HEADER_BITS])
            for b in range(w)
        ],
        dim=-2,
    )  # [..., W, 22]
    valid = crc.crc24_check(hdr)
    user = hdr[..., : fs.HEADER_USER_BYTES]
    plen = (hdr[..., 14].to(torch.int32) << 8) | hdr[..., 15].to(torch.int32)
    mod = hdr[..., 16].to(torch.int32)
    inner = hdr[..., 17].to(torch.int32)
    outer = hdr[..., 18].to(torch.int32)
    return (valid, user, plen, mod, inner, outer), hdr


def decode_header_full(hdr_syms: torch.Tensor):
    """[..., 180] header symbols -> ((header_valid, user_bytes[..., 14],
    payload_len, modulation, inner, outer), hdr_bytes[..., 22]): the
    one-branch case of decode_header_multi."""
    (v, u, pl, m, i, o), hb = decode_header_multi([hdr_syms])
    return (v[..., 0], u[..., 0, :], pl[..., 0], m[..., 0], i[..., 0], o[..., 0]), hb[..., 0, :]


def decode_header(hdr_syms: torch.Tensor):
    """[..., 180] header symbols -> (header_valid, user_bytes[..., 14],
    payload_len, modulation, inner, outer)."""
    return decode_header_full(hdr_syms)[0]


def _header_reference_symbols(hdr_bytes: torch.Tensor) -> torch.Tensor:
    """Re-encode decoded header bytes [..., 22] back to the TX's 180 QPSK
    header symbols: bit-exactly the transmitted header when its CRC passed."""
    return header_bytes_to_symbols(hdr_bytes)


# ---------------------------------------------------------------------------
# linear equalizer
# ---------------------------------------------------------------------------

EQ_TAPS = 8
EQ_LAM_REL = 1e-3  # ridge of the channel LS, relative to the mean Gram diagonal


@functools.lru_cache(maxsize=None)
def _preamble_estimator() -> tuple[np.ndarray, np.ndarray, float, int]:
    """For the KNOWN-constant preamble reference, the design matrix D, the
    regularized LS estimator A = (D^H D + lam I)^-1 D^H and the training
    power are numpy constants: (A [L, rows], D [rows, L], p_train, rows)."""
    L = EQ_TAPS
    c = L // 2
    n0 = L - 1 - c
    rnp = np.asarray(msequence.preamble_symbols(), dtype=np.complex64)
    rows = len(rnp) - L + 1
    D_np = np.stack([rnp[n0 + c - t : n0 + c - t + rows] for t in range(L)], axis=-1)
    G_np = D_np.conj().T @ D_np
    lam_np = EQ_LAM_REL * max(float(np.mean(np.real(np.diag(G_np)))), 1e-12)
    A_est = np.linalg.inv(G_np + lam_np * np.eye(L)) @ D_np.conj().T
    p_train = float(np.mean(np.abs(rnp) ** 2))
    return A_est.astype(np.complex64), D_np.astype(np.complex64), p_train, rows


def _bf16_round(a: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back: the operand rounding of the reference's
    Gram products, with the contraction itself left in float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def _eq_train(syms: torch.Tensor, ref: torch.Tensor | None) -> torch.Tensor:
    """Train a symbol-spaced linear equalizer on known reference symbols.

    The *indirect* (estimate-then-invert) design:

    1. *Channel estimate*: LS of received on the KNOWN CLEAN reference,
       syms[m] = sum_t h[t] ref[m+c-t] + noise.
    2. *Model-order gate* (positive-part James-Stein) on the ISI taps only:
       h' = h_c delta + kappa (h - h_c delta), kappa = (1 - null/|isi|)_+
       with null = sigma^2 (L-1)/(N P) the pure-noise expectation. The lag-0
       tap h_c is always kept.
    3. *Ensemble MMSE inverse*: w solves (P R + sigma^2 I) w = P conj(hbar)
       with R the channel autocorrelation implied by h' and
       hbar[i] = h'[2c-i].
    4. *Unbiasing*: w /= g0 with g0 = sum_t w[t] h'[c-t] restores the unit
       decision scale.

    ``ref``: [..., n_ref] known symbols aligned with ``syms[..., :n_ref]``,
    or ``None`` for the constant preamble, whose estimator is precomputed.
    Returns taps [..., EQ_TAPS] for _eq_apply.
    """
    L = EQ_TAPS
    c = L // 2
    n0 = L - 1 - c
    dev = syms.device
    if ref is None:
        A_np, D_np, p_train_f, rows = _preamble_estimator()
        A_est = device_const(("eq_pre_A",), lambda: A_np, dev)
        D_c = device_const(("eq_pre_D",), lambda: D_np, dev)
        y = syms[..., n0 : n0 + rows]
        h = y @ A_est.T  # [..., L]
        resid = y - h @ D_c.T
        p_train = device_const(("eq_pre_p_train",), lambda: np.float32(p_train_f), dev)
    else:
        n_ref = ref.shape[-1]
        rows = n_ref - L + 1  # targets m = n0 .. n_ref-1-c: full regressor span
        y = syms[..., n0 : n0 + rows]
        ref_b = ref.expand(syms.shape[:-1] + (n_ref,))
        # D[n, t] = ref[n0 + n + c - t]; y[n] = syms[n0 + n]
        D = torch.stack(
            [ref_b[..., n0 + c - t : n0 + c - t + rows] for t in range(L)], dim=-1
        )  # [..., rows, L]
        # Gram + cross-correlation with operands rounded to bf16 and float32
        # accumulation, as the reference does on every backend: these are
        # noise-averaged statistics over ``rows`` symbols
        Dr, Di = _bf16_round(D.real), _bf16_round(D.imag)
        mm = lambda a, b: torch.einsum("...nl,...nm->...lm", a, b)
        Grr = mm(Dr, Dr) + mm(Di, Di)
        Gri = mm(Dr, Di) - mm(Di, Dr)
        G = torch.complex(Grr, Gri)
        yr, yi = _bf16_round(y.real), _bf16_round(y.imag)
        mv = lambda a, b: torch.einsum("...nl,...n->...l", a, b)
        rhs = torch.complex(mv(Dr, yr) + mv(Di, yi), mv(Dr, yi) - mv(Di, yr))
        diag = torch.diagonal(G, dim1=-2, dim2=-1).real
        lam = EQ_LAM_REL * torch.clamp(torch.mean(diag, dim=-1), min=1e-12)
        G = G + lam[..., None, None] * torch.eye(L, dtype=G.dtype, device=dev)
        h = _solve_hermitian(G, rhs)  # [..., L] channel estimate
        resid = y - torch.einsum("...nl,...l->...n", D, h)
        p_train = torch.clamp(torch.mean(torch.abs(ref_b) ** 2, dim=-1), min=1e-12)

    # noise estimate from the channel-fit residual (bias-corrected)
    sigma2 = torch.mean(torch.abs(resid) ** 2, dim=-1) * (rows / max(rows - L, 1))

    # James-Stein gate on the ISI taps (lag-0 always kept)
    delta = device_const(("eq_delta", L), lambda: np.eye(L, dtype=np.complex64)[c], dev)
    hc = h[..., c]
    e = h - hc[..., None] * delta
    isi = torch.sum(torch.abs(e) ** 2, dim=-1)
    null = sigma2 * ((L - 1) / rows) / p_train
    kappa = torch.clamp(1.0 - null / torch.clamp(isi, min=1e-20), 0.0, 1.0)
    h = hc[..., None] * delta + kappa[..., None].to(h.dtype) * e

    # ensemble MMSE equalizer for (h, sigma2): M w = rhs_w with
    # M[i, j] = P R[i - j] + sigma2 I, rhs_w[i] = P conj(h[c - i])
    lead = h.shape[:-1]
    hp = torch.cat(
        [
            torch.zeros(lead + (L,), dtype=h.dtype, device=dev),
            h,
            torch.zeros(lead + (2 * L - 1,), dtype=h.dtype, device=dev),
        ],
        dim=-1,
    )  # safe lags
    R = torch.stack(
        [
            torch.sum(
                hp[..., L : 3 * L] * torch.conj(hp[..., L - k : 3 * L - k]), dim=-1
            )
            for k in range(-(L - 1), L)
        ],
        dim=-1,
    )  # [..., 2L-1], R[k + L-1] = sum_m h[m] conj(h[m-k])
    toep = device_const(
        ("eq_toeplitz", L), lambda: np.subtract.outer(np.arange(L), np.arange(L)) + L - 1, dev)
    M = (
        p_train[..., None, None] * R[..., toep]
        + sigma2[..., None, None] * torch.eye(L, dtype=h.dtype, device=dev)
    )
    # h is estimated in the same centered convention as w (tap t multiplies
    # a (t - c)-delayed symbol), so the equalizer cascade's signal path is
    # hbar[i] = h[2c - i], i = 0..L-1 (zero outside [0, L))
    hbar = torch.flip(hp[..., 2 * c + 1 : 2 * c + 1 + L], dims=(-1,))
    w = _solve_hermitian(M, p_train[..., None] * torch.conj(hbar))

    # unbias the signal-path gain (decision devices need unit scale);
    # |g0| is clamped to [1/2, 2]
    g0 = torch.sum(w * hbar, dim=-1)
    g0a = torch.abs(g0)
    g0m = torch.clamp(g0a, 0.5, 2.0)
    g0 = torch.where(g0a > 1e-3, g0 / g0a, torch.ones_like(g0)) * g0m
    w = w / g0[..., None]

    # model-sanity gate: when the LTI fit leaves most of the signal power
    # unexplained, no FIR taps are trustworthy; fall back to the identity
    bad = sigma2 > 0.6 * p_train
    return torch.where(bad[..., None], delta, w).to(torch.complex64)


def _solve_hermitian(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the Hermitian-PD complex system G w = rhs, batched, by
    conjugate gradients: exact in <= L steps for an L-dimensional PD system
    (L = 8 here). Degenerate all-zero slots (masked detections) keep x = 0
    via the guarded denominators."""
    L = G.shape[-1]
    x = torch.zeros_like(rhs)
    r = rhs
    p = r
    rs = torch.sum(torch.abs(r) ** 2, dim=-1)
    for _ in range(L):
        gp = torch.einsum("...ij,...j->...i", G, p)
        denom = torch.clamp(torch.sum(torch.conj(p) * gp, dim=-1).real, min=1e-30)
        alpha = (rs / denom).to(G.dtype)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * gp
        rs_new = torch.sum(torch.abs(r) ** 2, dim=-1)
        beta = (rs_new / torch.clamp(rs, min=1e-30)).to(G.dtype)
        p = r + beta[..., None] * p
        rs = rs_new
    return x.to(torch.complex64)


def _eq_apply(w: torch.Tensor, syms: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """Apply equalizer taps [..., L] to symbols [..., n]:
    z[n] = sum_t w[t] syms[n + c - t], same indexing as _eq_train.

    ``n_out`` limits the output length (the caller passes a context slice
    ``syms[..., :n_out + c]`` to equalize only a prefix region cheaply)."""
    L = EQ_TAPS
    c = L // 2
    n = syms.shape[-1]
    if n_out is None:
        n_out = n
    lead = syms.shape[:-1]
    back = max(0, n_out + c - n)
    zeros = lambda k: torch.zeros(lead + (k,), dtype=syms.dtype, device=syms.device)
    q = torch.cat([zeros(L - 1 - c), syms, zeros(back)], dim=-1)  # q[i] = syms[i-(L-1-c)]
    z = torch.zeros(lead + (n_out,), dtype=torch.complex64, device=syms.device)
    for t in range(L):
        z = z + w[..., t, None] * q[..., L - 1 - t : L - 1 - t + n_out]
    return z


# ---------------------------------------------------------------------------
# carrier model
# ---------------------------------------------------------------------------


def _ipow(z: torch.Tensor, m: int) -> torch.Tensor:
    """z**m for a small positive integer m by repeated multiplication (a
    complex ``pow`` goes through exp/log and loses bits)."""
    out = None
    base = z
    while m:
        if m & 1:
            out = base if out is None else out * base
        m >>= 1
        if m:
            base = base * base
    return out


def _mth_power_phase(table_np: np.ndarray, m: int) -> tuple[complex, float]:
    """The constellation's m-th-moment (complex) and its phase psi."""
    unit = table_np / np.maximum(np.abs(table_np), 1e-12)
    moment = np.mean(unit**m * np.abs(table_np))
    return moment, float(np.angle(moment))


def _vv_stat(r: torch.Tensor, m: int) -> torch.Tensor:
    """Viterbi&Viterbi statistic (r/|r|)^m |r| per symbol."""
    mag = torch.abs(r)
    return _ipow(r / torch.clamp(mag, min=1e-12), m) * mag


def _carrier_fit(syms: torch.Tensor, pre_ref: torch.Tensor):
    """Fit the (phi_b, dphi) linear phase model from the preamble + header
    region ``syms[..., :h1]``, decision-free:

    - the *known* preamble gives an exact, ambiguity-free phase anchor phi_a
      at the preamble center;
    - the header (always QPSK, unknown bits) gives a Viterbi&Viterbi
      4th-power anchor with no decision fold; its two half-sums also give a
      fold-free frequency estimate used only to *predict* the header-center
      phase well enough to resolve the mod-(pi/2) branch of the anchor;
    - the final model is the two-point fit through (phi_a, phi_b).
    """
    h0 = fs.PREAMBLE_SYMS
    h1 = h0 + fs.HEADER_SYMS

    q = syms[..., :h0] * torch.conj(pre_ref)
    q1 = torch.sum(q[..., : h0 // 2], dim=-1)
    q2 = torch.sum(q[..., h0 // 2 :], dim=-1)
    phi_a = torch.angle(q1 + q2)  # exact phase @ preamble center
    n_a = (h0 - 1) / 2.0

    u = _vv_stat(syms[..., h0:h1], 4)
    half = fs.HEADER_SYMS // 2
    u1 = torch.sum(u[..., :half], dim=-1)
    u2 = torch.sum(u[..., half:], dim=-1)
    slope_h = torch.angle(u2 * torch.conj(u1)) / (4.0 * half)  # rad/sym, fold-free
    # psi: 4th-moment phase of the header constellation (pi for this QPSK)
    _, psi = _mth_power_phase(modem.constellation(fs.HEADER_MOD), 4)
    n_b = h0 + (fs.HEADER_SYMS - 1) / 2.0
    phi_b = torch.angle((u1 + u2) * complex(np.exp(-1j * psi))) / 4.0  # mod pi/2
    pred = phi_a + slope_h * (n_b - n_a)
    phi_b = phi_b + (np.pi / 2.0) * torch.round((pred - phi_b) / (np.pi / 2.0))

    dphi = (phi_b - phi_a) / (n_b - n_a)
    return phi_b, dphi


def _apply_carrier(syms: torch.Tensor, phi_b: torch.Tensor, dphi: torch.Tensor) -> torch.Tensor:
    """Derotate by the fitted model, anchored at the header center n_b."""
    n_b = fs.PREAMBLE_SYMS + (fs.HEADER_SYMS - 1) / 2.0
    n = torch.arange(syms.shape[-1], dtype=torch.float32, device=syms.device)
    return syms * expj(-(phi_b[..., None] + dphi[..., None] * (n - n_b)))


def _refine_carrier(syms: torch.Tensor, pre_ref: torch.Tensor) -> torch.Tensor:
    """Decision-free residual carrier correction from preamble + header
    (_carrier_fit), applied to the whole symbol stream; payload residuals are
    left to the payload tracker."""
    return _apply_carrier(syms, *_carrier_fit(syms, pre_ref))


# ---------------------------------------------------------------------------
# common sync front-end (detect + symbols + header), then the payload back-end
# ---------------------------------------------------------------------------


def sync_symbols(syms: torch.Tensor, tables: PhyTables, refine: bool = True,
                 equalize: bool = True):
    """Stage 4 on recovered symbols [B, K, n_syms]: two-stage equalizer,
    carrier fit, three-branch header decode. Returns (refined symbols,
    (hdr_valid, user, plen, mod, inner, outer), evm_lin, hdr_tx_ref), where
    hdr_tx_ref is ``None`` with ``equalize=False``.

    EQ1 trained on the 64 known preamble symbols gets the header decodable
    under static ISI; once the header decodes, EQ2 retrains on preamble +
    re-encoded header (244 known symbols) and re-equalizes the whole frame
    for the payload. Invalid-header candidates keep the EQ1 taps.

    The header is decoded from the equalized, the raw and a per-segment
    tracked stream in ONE pass, and any CRC pass is accepted, preferring
    equalized, then raw, then tracked. ``refine`` fits the linear carrier
    model to the equalized and raw branches and derotates the stream by the
    winning one. ``equalize=False`` decodes the header once, from the stream
    refined by one carrier fit (``refine``) or as it came.
    """
    h0, h1 = fs.PREAMBLE_SYMS, fs.PREAMBLE_SYMS + fs.HEADER_SYMS
    pre_ref = tables.preamble
    hdr_tx_ref = None
    if not equalize:
        if refine:
            syms = _refine_carrier(syms, pre_ref)
        fields = decode_header(syms[..., h0:h1])
    else:
        w1 = _eq_train(syms, None)
        c = EQ_TAPS // 2
        hdr_region = _eq_apply(w1, syms[..., : h1 + c], n_out=h1)
        raw_region = syms[..., :h1]
        # absolute phase at the preamble tail of the EQ1 stream (known
        # symbols: no modular ambiguity) anchors the tracked header branch
        # independently of the linear carrier fit
        qp1 = torch.sum(
            hdr_region[..., h0 - 32 : h0 - 16] * torch.conj(pre_ref[-32:-16]), dim=-1
        )
        qp2 = torch.sum(hdr_region[..., h0 - 16 : h0] * torch.conj(pre_ref[-16:]), dim=-1)
        slope_pre = torch.angle(qp2 * torch.conj(qp1)) / 16.0  # rad/symbol
        # extrapolate to the center of the first tracked header segment
        # (seg=18): 8 symbols from the qp2 center to h0, +9 into the header
        anchor_pre = torch.angle(qp2) + slope_pre * (8.0 + 9.0)
        hdr_pre_fit = hdr_region  # EQ1 stream before any carrier model
        if refine:
            fit_eq = _carrier_fit(hdr_region, pre_ref)
            fit_raw = _carrier_fit(syms, pre_ref)
            hdr_region = _apply_carrier(hdr_region, *fit_eq)
            raw_region = _apply_carrier(raw_region, *fit_raw)
        hdr_trk = _dd_phase_track(
            hdr_pre_fit[..., h0:h1], fs.HEADER_MOD, seg=18,
            anchor=anchor_pre, anchor_slope=slope_pre,
        )
        (v3, u3, pl3, m3, i3, o3), hb3 = decode_header_multi(
            [hdr_region[..., h0:h1], raw_region[..., h0:h1], hdr_trk]
        )
        v_eq, v_raw, v_trk = v3[..., 0], v3[..., 1], v3[..., 2]
        hdr_valid = v_eq | v_raw | v_trk
        pick = v_eq  # prefer the equalized decode, then raw, then tracked
        p_raw = (~v_eq) & v_raw

        def pick3(a):  # a: [..., 3] or [..., 3, n]
            if a.dim() == v3.dim():
                return torch.where(pick, a[..., 0], torch.where(p_raw, a[..., 1], a[..., 2]))
            return torch.where(
                pick[..., None], a[..., 0, :],
                torch.where(p_raw[..., None], a[..., 1, :], a[..., 2, :]),
            )

        user, plen, mod, inner, outer = (pick3(a) for a in (u3, pl3, m3, i3, o3))
        fields = (hdr_valid, user, plen, mod, inner, outer)
        hdr_bytes = pick3(hb3)
        if refine:
            # derotate the full stream with the winning branch's fit (the
            # tracked branch rides the EQ branch's fit)
            use_eq_fit = pick | (~p_raw)
            phi_b = torch.where(use_eq_fit, fit_eq[0], fit_raw[0])
            dphi = torch.where(use_eq_fit, fit_eq[1], fit_raw[1])
            syms = _apply_carrier(syms, phi_b, dphi)
        hdr_tx_ref = _header_reference_symbols(hdr_bytes)  # [B, K, 180]
        refs = torch.cat(
            [pre_ref.expand(hdr_tx_ref.shape[:-1] + (h0,)), hdr_tx_ref], dim=-1
        )
        w2 = _eq_train(syms, refs)
        w = torch.where(hdr_valid[..., None], w2, w1)
        syms = _eq_apply(w, syms)

    # header EVM from the refined symbols' own hard decisions
    hdr_idx = modem.demod_hard(syms[..., h0:h1], fs.HEADER_MOD)
    hdr_dec_ref = modem.modulate(hdr_idx, fs.HEADER_MOD)
    evm_lin = torch.mean(torch.abs(syms[..., h0:h1] - hdr_dec_ref) ** 2, dim=-1)
    return syms, fields, evm_lin, hdr_tx_ref


def sync_common(
    x: torch.Tensor,
    n_syms: int,
    max_frames: int,
    threshold: float = 0.45,
    refine: bool = True,
    timing_bank: bool = True,
    equalize: bool = True,
    track_sfo: bool | str = "auto",
    det_override: Detections | None = None,
    fine: bool = True,
    return_peak_count: bool = False,
    return_hdr_ref: bool = False,
    *,
    tables: PhyTables | None = None,
    device: torch.device | str | None = None,
):
    """Config-independent RX front-end: [B, T] -> (det, refined symbols
    [B, K, n_syms], header fields, header EVM), then the peak count per row
    with ``return_peak_count`` and the re-encoded header symbols with
    ``return_hdr_ref``. ``n_syms`` is the symbol-buffer size (the longest
    frame the caller expects).

    ``track_sfo``: ``"auto"`` tracks sample-clock drift where
    ``n_syms >= SFO_AUTO_SYMS``. ``det_override`` replaces the detector with
    externally supplied candidates (on ``device``); ``fine=False`` skips the
    per-frame fine-CFO refinement. ``evm_lin`` [B, K] is the post-refinement
    header-symbol error-vector power: the per-frame noise-variance estimate
    the payload soft demod consumes.
    """
    dev = resolve_device(device)
    if tables is None:
        tables = phy_tables(None, dev)
    x = x.to(device=dev, dtype=torch.complex64).contiguous()
    peak_count = None
    if det_override is not None:
        det = det_override
        if return_peak_count:
            peak_count = torch.sum(det.mask.to(torch.int32), dim=-1, dtype=torch.int32)
    elif return_peak_count:
        det, peak_count = detect(x, max_frames, threshold, fine=False, return_count=True,
                                 tables=tables, device=dev)
    else:
        det = detect(x, max_frames, threshold, fine=False, tables=tables, device=dev)
    if track_sfo == "auto":
        # sample-clock drift only walks off the symbol grid on long frames
        track_sfo = n_syms >= SFO_AUTO_SYMS
    det, syms = recover_candidates(x, det, n_syms, tables, timing_bank, track_sfo, fine)
    syms, fields, evm_lin, hdr_tx_ref = sync_symbols(syms, tables, refine, equalize)
    out = (det, syms, fields, evm_lin)
    if return_peak_count:
        out = out + (peak_count,)
    if return_hdr_ref:
        out = out + (hdr_tx_ref,)
    return out


DD_PASSES = 2  # tracker passes: V&V (when it runs) counts as the first


def _f32(v: torch.Tensor | float, device: torch.device) -> torch.Tensor:
    """A float32 tensor on ``device``: ``v`` itself, or a Python number
    written by a fill on the device (no copy from the host, so that the call
    can run inside a CUDA graph)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), v, dtype=torch.float32, device=device)


def _segment_interp(nseg: int, seg: int, device: torch.device):
    """(j_lo [nseg*seg] int64, fr [nseg*seg] float32): the piecewise-linear
    interpolation between segment centers, as tables on ``device``."""
    def build():
        t_pos = (np.arange(nseg * seg, dtype=np.float32) - (seg - 1) / 2.0) / seg
        j_lo = np.clip(np.floor(t_pos).astype(np.int64), 0, nseg - 2)
        return j_lo, np.clip(t_pos - j_lo, 0.0, 1.0).astype(np.float32)

    return (device_const(("dd_interp_j", nseg, seg), lambda: build()[0], device),
            device_const(("dd_interp_fr", nseg, seg), lambda: build()[1], device))


def _median_last(a: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, keeping it, with the mean of the two middle
    values for an even count (``torch.median`` returns the lower one)."""
    n = a.shape[-1]
    s = torch.sort(a, dim=-1).values
    if n % 2:
        return s[..., n // 2 : n // 2 + 1]
    return s[..., n // 2 - 1 : n // 2] * 0.5 + s[..., n // 2 : n // 2 + 1] * 0.5


def _dd_phase_track(
    pay: torch.Tensor,
    mod: int,
    seg: int = 64,
    anchor: torch.Tensor | float = 0.0,
    anchor_slope: torch.Tensor | float = 0.0,
    return_weight: bool = False,
):
    """Decision-directed segment-wise carrier tracking over payload symbols.

    Split the symbols into ``seg``-symbol segments. When cycle slips are
    plausible, a decision-free first pass runs: per segment, the
    Viterbi&Viterbi m-th-power statistic u_i = sum (r/|r|)^m |r| has angle
    m*theta_i + psi_m with no fold and no bias (psi_m the constellation's
    m-th-moment phase). For strong-moment (PSK) constellations the
    per-segment phases are unwrapped into a trajectory by a slope-predictive,
    confidence-gated chain anchored at ``anchor`` (absolute phase at the
    center of segment 0, ``anchor_slope`` its rad/symbol rate) and
    interpolated linearly between segment centers; weak-moment (QAM/ASK)
    constellations take a 2-parameter linear fit over all segments. The
    corrected residual is then small enough for plain per-segment
    decision-directed complex-gain passes (``_dd_gain_passes``).

    The V&V stage is gated on actual slip risk: the worst plausible
    post-refine drift over this span must reach an appreciable fraction of
    the symmetry angle, and QAM/ASK additionally need enough symbols to
    average the estimator's modulation self-noise. Differential schemes are
    returned unchanged (immune by construction), with unit weights.
    """
    if modem.is_differential(mod):
        if return_weight:
            return pay, torch.ones(pay.shape, dtype=torch.float32, device=pay.device)
        return pay
    dev = pay.device
    sym_rot = modem.rotational_symmetry(mod)
    m = int(round(2 * np.pi / sym_rot))
    table_np = modem.constellation(mod)
    moment, psi = _mth_power_phase(table_np, m)
    unpsi = complex(np.exp(-1j * psi))
    n = pay.shape[-1]
    nseg = -(-n // seg)
    pad = nseg * seg - n
    lead = pay.shape[:-1]

    # slip risk: 5-sigma residual slope after the decision-free refine
    # (~2.7e-4 rad/sym sigma at the lowest workable SNR) over the span
    drift_5sigma = 1.4e-3 * n
    use_vv = (
        nseg >= 2
        and drift_5sigma > sym_rot / 8
        and (abs(moment) > 0.9 or abs(moment) * np.sqrt(n) >= 3.0)
    )

    p = torch.cat([pay, torch.zeros(lead + (pad,), dtype=pay.dtype, device=dev)], dim=-1)
    p = p.reshape(lead + (nseg, seg))

    if use_vv:
        u = torch.sum(_vv_stat(p, m), dim=-1)  # [..., nseg]
        period = sym_rot  # = 2*pi/m
        if abs(moment) <= 0.6:
            # weak-moment QAM/ASK: segments are too noisy individually; a
            # linear fit averages the self-noise across ALL segments
            slope = torch.angle(torch.sum(u[..., 1:] * torch.conj(u[..., :-1]), dim=-1)) / m
            slope = torch.clamp(slope, -sym_rot / 4, sym_rot / 4)  # rad per segment
            seg_idx = torch.arange(nseg, dtype=torch.float32, device=dev)
            detrend = expj(-m * slope[..., None] * seg_idx)
            a = torch.angle(torch.sum(u * detrend, dim=-1) * unpsi) / m
            t_idx = torch.arange(nseg * seg, dtype=torch.float32, device=dev)
            phi = a[..., None] + (slope[..., None] / seg) * (t_idx - (seg - 1) / 2.0)
            flat = p.reshape(lead + (nseg * seg,)) * expj(-phi)
            return _dd_gain_passes(flat, pay, mod, nseg, seg, n, DD_PASSES - 1,
                                   return_weight=return_weight)
        # Branch chaining is slope-predictive AND confidence-gated: segment
        # i resolves its fold against th_{prev} + slope (a segment-granular
        # first-order PLL), with the slope updated as an EMA over confident
        # increments and the reference frozen across deep-fade segments.
        # Branch decisions use a slope-detrended 1-2-1 smoothing of the
        # neighboring V&V statistics.
        conf = torch.abs(u)
        thr = 0.35 * _median_last(conf)
        anchor = _f32(anchor, dev)
        slope = (_f32(anchor_slope, dev) * seg).expand(lead)  # rad per segment
        half_p = period / 2.0

        def th_at(i, slope):
            us = u[..., i]
            rot = expj(m * slope)
            if i > 0:
                us = us + 0.5 * u[..., i - 1] * rot
            if i + 1 < nseg:
                us = us + 0.5 * u[..., i + 1] * torch.conj(rot)
            return torch.angle(us * unpsi) / m

        th_0 = th_at(0, slope)
        b0 = torch.round((th_0 - anchor) / period)
        th0 = th_0 - b0 * period
        th = [th0]
        good = conf[..., 0] > thr[..., 0]
        ref = torch.where(good, th0, anchor.expand(th0.shape))
        for i in range(1, nseg):
            pred = ref + slope
            th_raw_i = th_at(i, slope)
            b = torch.round((th_raw_i - pred) / period)
            th_i = th_raw_i - b * period
            th.append(th_i)
            good_i = conf[..., i] > thr[..., 0]
            inc = torch.clamp(th_i - ref, -1.2 * half_p, 1.2 * half_p)
            both = good & good_i
            slope = torch.where(both, 0.5 * slope + 0.5 * inc, slope)
            ref = torch.where(good_i, th_i, ref + slope)
            good = good_i
        th = torch.stack(th, dim=-1)  # [..., nseg] unwrapped
        # piecewise-linear interpolation between segment centers
        j_lo, fr = _segment_interp(nseg, seg, dev)
        phi = th[..., j_lo] * (1.0 - fr) + th[..., j_lo + 1] * fr
        flat = p.reshape(lead + (nseg * seg,)) * expj(-phi)
        n_dd = DD_PASSES - 1
    else:
        flat = p.reshape(lead + (nseg * seg,))
        n_dd = DD_PASSES

    return _dd_gain_passes(flat, pay, mod, nseg, seg, n, n_dd, return_weight=return_weight)


def _dd_gain_passes(flat, pay, mod, nseg, seg, n, n_dd, return_weight=False):
    """Independent per-segment decision-directed COMPLEX GAIN passes
    (residual assumed well inside the decision regions).

    The LS gain g = <p, d>/<d, d> corrects phase AND amplitude; |g| is
    clamped to [1/4, 4] so a deep-null segment cannot blow up the symbols.
    The tail segment is zero-padded: decisions OF the pad are nonzero
    constellation points, so the gain denominator counts only real symbols.
    With ``return_weight`` also returns the cumulative unclamped |g| per
    symbol, the fading weight of the LLRs.
    """
    dev = flat.device
    lead = pay.shape[:-1]
    table = modem.constellation_t(mod, dev)
    valid = device_const(
        ("dd_valid", nseg, seg, n),
        lambda: (np.arange(nseg * seg) < n).reshape(nseg, seg).astype(np.float32), dev)
    wmag = None
    for _ in range(n_dd):
        p = flat.reshape(lead + (nseg, seg))
        idx = modem.demod_hard(p, mod)
        d = table[idx.to(torch.int64)] * valid
        e = torch.sum(p * torch.conj(d), dim=-1)  # [..., nseg]
        pd = torch.clamp(torch.sum(torch.abs(d) ** 2, dim=-1), min=1e-12)
        g = e / pd
        ga = torch.abs(g)
        mag = torch.clamp(ga, 0.25, 4.0)
        g = torch.where(ga > 1e-6, g / ga, torch.ones_like(g)) * mag
        flat = (p / g[..., None]).reshape(lead + (nseg * seg,))
        if return_weight:
            m_raw = torch.clamp(torch.abs(e) / pd, 1e-3, 4.0)
            wmag = m_raw if wmag is None else wmag * m_raw
    if return_weight:
        if wmag is None:
            w_sym = torch.ones(lead + (n,), dtype=torch.float32, device=dev)
        else:
            w_sym = torch.repeat_interleave(wmag, seg, dim=-1)[..., :n]
        return flat[..., :n], w_sym
    return flat[..., :n]


def decode_payload_symbols(
    syms: torch.Tensor,
    cfg: FrameConfig,
    track: bool = True,
    noise_var: torch.Tensor | float | None = None,
    anchor: torch.Tensor | None = None,
    anchor_slope: torch.Tensor | float = 0.0,
    slip_retry: bool = False,
    *,
    tables: PhyTables | None = None,
):
    """Fixed-config payload back-end: symbols [.., n_syms >= frame_syms] ->
    (payload bytes [..., payload_len], crc_ok bool[...]).

    ``noise_var``: per-frame noise-variance estimate for LLR scaling (the
    header EVM from sync_common), scalar or [...]; 0.1 when ``None``.
    ``anchor``: absolute phase at the payload start (symbol h1) for the
    payload tracker's segment-0 branch, with ``anchor_slope`` its rad/symbol
    rate (framesync_fixed reconstructs both from the re-encoded decoded
    header). Without it, a V&V estimate of the header tail is used (fold-free
    only while the residual there is < pi/4). ``track=False`` skips the
    carrier tracker and its fading weights.

    ``slip_retry`` (with the tracker, coherent modulations): across a deep
    fade the tracker's fold decision runs blind, and if the true phase moved
    by more than half a symmetry period there, every later segment comes
    out rotated by exactly one period. The least-confident segment (the
    fade minimum of the gain weights) marks the slip, so three candidates
    are decoded in one batch, as tracked and rotated by +-one period from
    the boundary after that segment, and CRC-24 picks: the first that
    passes (as tracked on a tie).
    """
    if tables is None:
        tables = phy_tables(cfg, syms.device)
    spec = fs.FrameSpec(cfg)
    h1 = fs.PREAMBLE_SYMS + fs.HEADER_SYMS
    pay = syms[..., h1 : h1 + spec.payload_syms]
    dev = syms.device
    gmag = None
    if track:
        if anchor is None:
            # header-tail V&V anchor (always QPSK, m=4): chains the payload
            # trajectory to the last known-good phase
            ut = torch.sum(_vv_stat(syms[..., h1 - 40 : h1], 4), dim=-1)
            _, psi4 = _mth_power_phase(modem.constellation(fs.HEADER_MOD), 4)
            anchor = torch.angle(ut * complex(np.exp(-1j * psi4))) / 4.0
        # Pre-derotate the payload by the measured header-exit line (anchor
        # phase + slope): the residual the tracker sees then starts at ~zero
        # phase and ~zero slope
        t_rel = torch.arange(pay.shape[-1], dtype=torch.float32, device=dev)
        slope = _f32(anchor_slope, dev)
        line = anchor[..., None] + slope[..., None] * t_rel
        pay = pay * expj(-line)
        pay, gmag = _dd_phase_track(pay, cfg.modulation, seg=32, return_weight=True)
    if noise_var is None:
        noise_var = 0.1
    nv = torch.clamp(_f32(noise_var, dev), min=1e-4)
    if nv.dim():
        nv = nv[..., None]  # broadcast over the per-symbol axis
    if gmag is not None:
        # Fading-aware LLR scaling: the gain passes DIVIDED each segment by
        # its estimated complex gain, so post-normalization noise is up by
        # 1/|g|^2 there
        nv = nv / torch.square(gmag)
    retry = slip_retry and gmag is not None and not modem.is_differential(cfg.modulation)
    if retry:
        seg = 32
        js = torch.argmin(gmag[..., ::seg], dim=-1)  # [...] fade minimum
        t_idx = torch.arange(pay.shape[-1], device=dev)
        mask = (t_idx >= (js[..., None] + 1) * seg).to(torch.float32)
        rots = torch.stack([torch.zeros_like(mask), mask, -mask], dim=-2)
        period = modem.rotational_symmetry(cfg.modulation)
        pay = pay[..., None, :] * expj(period * rots)  # [..., 3, n]
        nv = nv[..., None, :] if nv.dim() else nv
    llr = modem.demod_soft_bits(pay, cfg.modulation, nv)
    llr = llr[..., : spec.inner_bits]  # drop modulation pad bits
    llr = llr[..., tables.interleave_inv]
    obits = registry.inner_decode(llr, spec.outer_bits, cfg.inner_code)
    msg = registry.outer_decode(obits, spec.payload_msg_bytes, cfg.outer_code)
    crc_ok = crc.crc24_check(msg)
    if retry:
        # the first CRC pass wins (candidate 0, as tracked, on a tie)
        pick = torch.argmax(crc_ok.to(torch.int32), dim=-1)
        idx = pick[..., None, None].expand(pick.shape + (1, msg.shape[-1]))
        msg = torch.gather(msg, -2, idx)[..., 0, :]
        crc_ok = torch.any(crc_ok, dim=-1)
    return msg[..., : cfg.payload_len], crc_ok


def framesync_fixed(
    x: torch.Tensor,
    cfg: FrameConfig,
    max_frames: int,
    threshold: float = 0.45,
    refine: bool = True,
    timing_bank: bool = True,
    equalize: bool = True,
    track_sfo: bool | str = "auto",
    det_override: Detections | None = None,
    fine: bool = True,
    track: bool = True,
    noise_var_override: torch.Tensor | float | None = None,
    return_peak_count: bool = False,
    slip_retry: bool = False,
    *,
    tables: PhyTables | None = None,
    device: torch.device | str | None = None,
):
    """Full RX for blocks known to carry frames of one config.

    [B, T] samples -> FrameResults with [B, K] slots, on ``device``
    (``None``: the GPU), and the peak count per row with
    ``return_peak_count``. Frames straddling the block end are not decoded.
    The options are sync_common's; ``track``, ``noise_var_override`` and
    ``slip_retry`` are decode_payload_symbols' ``track``, ``noise_var`` (the
    header EVM when ``None``) and ``slip_retry``.
    """
    dev = resolve_device(device)
    if tables is None:
        tables = phy_tables(cfg, dev)
    spec = fs.FrameSpec(cfg)
    sc = sync_common(
        x, spec.frame_syms, max_frames, threshold, refine, timing_bank, equalize,
        track_sfo, det_override=det_override, fine=fine,
        return_peak_count=return_peak_count, return_hdr_ref=True, tables=tables, device=dev,
    )
    det, syms, fields, evm_lin = sc[:4]
    res = _finish_fixed(det, syms, fields, evm_lin, sc[-1], cfg, tables, track,
                        noise_var_override, slip_retry)
    if return_peak_count:
        return res, sc[4]
    return res


def _finish_fixed(det, syms, fields, evm_lin, hdr_ref, cfg, tables, track=True,
                  noise_var=None, slip_retry=False) -> FrameResults:
    """Stage 5 and the result record, from the outputs of sync_common."""
    hdr_valid, user, plen, mod, inner, outer = fields
    if hdr_ref is None:
        # rebuild the TX header symbols from the DECODED header fields (user
        # + len + config + CRC24 -> Golay -> QPSK: bit-exact when header_valid)
        proto = torch.stack(
            [(plen >> 8) & 0xFF, plen & 0xFF, mod, inner, outer], dim=-1
        ).to(torch.uint8)
        hdr_ref = _header_reference_symbols(crc.crc24_append(torch.cat([user, proto], dim=-1)))
    # absolute payload-tracker anchor: correlate the header against the TX
    # header symbols rebuilt from the DECODED header. Slope from the two
    # 90-symbol header halves (long baseline), phase from the last 20
    # symbols (agile under fading).
    h1 = fs.PREAMBLE_SYMS + fs.HEADER_SYMS
    h0_ = h1 - 180
    u1 = torch.sum(syms[..., h0_ : h0_ + 90] * torch.conj(hdr_ref[..., :90]), dim=-1)
    u2 = torch.sum(syms[..., h0_ + 90 : h1] * torch.conj(hdr_ref[..., 90:]), dim=-1)
    a_slope = torch.angle(u2 * torch.conj(u1)) / 90.0  # rad/symbol
    a_slope = torch.clamp(a_slope, -0.025, 0.025)  # ramp sanity
    q2 = torch.sum(syms[..., h1 - 20 : h1] * torch.conj(hdr_ref[..., -20:]), dim=-1)
    anchor = torch.angle(q2) + a_slope * 10.0  # extrapolated to h1

    payload, crc_ok = decode_payload_symbols(
        syms, cfg, track, evm_lin if noise_var is None else noise_var, anchor, a_slope,
        slip_retry, tables=tables,
    )
    pay_valid = crc_ok & hdr_valid

    evm = 10.0 * torch.log10(torch.clamp(evm_lin, min=1e-12))
    rssi = 20.0 * torch.log10(torch.clamp(det.gamma, min=1e-12))

    cfg_match = (
        (mod == cfg.modulation)
        & (inner == cfg.inner_code)
        & (outer == cfg.outer_code)
        & (plen == cfg.payload_len)
    )
    return FrameResults(
        mask=det.mask,
        header_valid=hdr_valid & det.mask,
        payload_valid=pay_valid & cfg_match & det.mask,
        modulation=mod,
        inner_code=inner,
        outer_code=outer,
        payload_len=plen,
        header_user=user,
        payload=payload,
        symbols=syms,
        evm=evm,
        rssi=rssi,
        cfo=det.dphi,
        start=det.start,
    )
