"""The plain reference receiver: flexframe detection and decoding in plain
PyTorch, frozen for the benchmark.

It works out again, from the samples the program was handed, everything the
program's ``framesync_fixed`` returns for the benchmark's chains (QPSK, V27
or none, Golay or none, CRC-24) on its default path: preamble detection
(five CFO-binned templates, block local maxima, the top K by score), the
frame windows, the fine CFO, derotation and the 30-tap fractional-delay
matched filter, the two-stage equaliser, the carrier fit, the three-branch
header decode, the payload carrier tracker, soft demodulation, the
deinterleaver, Viterbi, the outer decode and the CRC. It follows the
port's receiver step for step (the same float32 formulas, the plain
versions of its kernels), so that the two agree to rounding; it imports
nothing of the program and takes nothing the program made.

``Precision`` is where the arithmetic's precision is set: ``float32`` is
the configuration's; ``bfloat16`` rounds the samples and every stage's
output to bfloat16 (the arithmetic stays float32, as in bf16 storage with
float32 accumulation). The second is the control of the benchmark's
correctness check: it has to come out as not correct.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools

import numpy as np
import torch

from rxbench import frame as fr
from rxbench import tx

NUM_TIMING_PHASES = 32
CFO_BINS = (-2, -1, 0, 1, 2)
TAU_BANK_PHASES = 16
TAU_BANK_RANGE = 12
EQ_TAPS = 8
EQ_LAM_REL = 1e-3


class Precision:
    """Rounding applied to the samples and to each stage's output."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"precision must be float32 or bfloat16, got {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        if t.is_complex():
            return torch.complex(t.real.to(torch.bfloat16).to(torch.float32),
                                 t.imag.to(torch.bfloat16).to(torch.float32))
        return t.to(torch.bfloat16).to(t.dtype)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _template_of(dt: float) -> np.ndarray:
    """The first 128 samples of the pulse-shaped preamble, pulse delayed by dt."""
    up = np.zeros(fr.TEMPLATE_LEN, dtype=np.complex64)
    up[::2] = tx.preamble_symbols()
    return np.convolve(up, tx.rrc_taps(dt))[: fr.TEMPLATE_LEN].astype(np.complex64)


@functools.lru_cache(maxsize=None)
def templates() -> np.ndarray:
    """[5, 128] the template shifted to each CFO bin."""
    s, n = _template_of(0.0), np.arange(fr.TEMPLATE_LEN)
    return np.stack([(s * np.exp(1j * 2.0 * np.pi * b * n / (2 * fr.TEMPLATE_LEN))).astype(
        np.complex64) for b in CFO_BINS])


@functools.lru_cache(maxsize=None)
def delayed_templates() -> np.ndarray:
    """[25, 128] the template with its pulse delayed by (q - 12) / 16 samples."""
    return np.stack([_template_of(q / TAU_BANK_PHASES)
                     for q in range(-TAU_BANK_RANGE, TAU_BANK_RANGE + 1)])


@functools.lru_cache(maxsize=None)
def timing_bank30() -> np.ndarray:
    """[33, 30] reversed fractional-delay matched filters, row q for a
    sampling offset of (q - 16) / 32 samples, the negative offsets shifted by
    one tap."""
    half = NUM_TIMING_PHASES // 2
    bank = np.stack([tx.rrc_taps(p / NUM_TIMING_PHASES) for p in range(NUM_TIMING_PHASES)])
    out = np.zeros((NUM_TIMING_PHASES + 1, fr.PULSE_LEN + 1), dtype=np.float32)
    for q in range(NUM_TIMING_PHASES + 1):
        p = q - half
        base = 1 if p < 0 else 0
        out[q, base : base + fr.PULSE_LEN] = bank[p + NUM_TIMING_PHASES if p < 0 else p][::-1]
    return out


@functools.lru_cache(maxsize=None)
def preamble_estimator():
    """(A [8, rows], D [rows, 8], training power, rows): the ridge LS channel
    estimator on the known preamble."""
    c = EQ_TAPS // 2
    n0 = EQ_TAPS - 1 - c
    r = tx.preamble_symbols()
    rows = len(r) - EQ_TAPS + 1
    d = np.stack([r[n0 + c - t : n0 + c - t + rows] for t in range(EQ_TAPS)], axis=-1)
    g = d.conj().T @ d
    lam = EQ_LAM_REL * max(float(np.mean(np.real(np.diag(g)))), 1e-12)
    a = np.linalg.inv(g + lam * np.eye(EQ_TAPS)) @ d.conj().T
    return a.astype(np.complex64), d.astype(np.complex64), float(np.mean(np.abs(r) ** 2)), rows


@functools.lru_cache(maxsize=None)
def golay_syndrome_table() -> np.ndarray:
    """[4096, 12] the data part of the lightest error pattern (weight 3 at
    most) of each syndrome; zero where no such pattern exists."""
    b = tx.golay_b().astype(np.int64)
    table = np.zeros((4096, 12), dtype=np.int64)
    filled = np.zeros(4096, dtype=bool)
    filled[0] = True
    for w in (1, 2, 3):
        for combo in itertools.combinations(range(24), w):
            e = np.zeros(24, dtype=np.int64)
            e[list(combo)] = 1
            s = int((((e[:12] @ b) % 2) ^ e[12:]) @ (1 << np.arange(12)))
            if not filled[s]:
                table[s], filled[s] = e[:12], True
    return table


@functools.lru_cache(maxsize=None)
def viterbi_signs() -> np.ndarray:
    """[64, 4] the expected LLR signs of the two branches into each state
    (from predecessors s >> 1 and (s >> 1) | 32, input s & 1)."""
    par = lambda v: bin(v).count("1") & 1
    s = np.arange(64)
    out = np.zeros((64, 4), dtype=np.float32)
    for sp in s:
        u = sp & 1
        for j, pred in enumerate((sp >> 1, (sp >> 1) | 32)):
            reg = ((pred << 1) | u) & 0x7F
            out[sp, 2 * j] = 1.0 - 2.0 * par(reg & tx.V27_G[0])
            out[sp, 2 * j + 1] = 1.0 - 2.0 * par(reg & tx.V27_G[1])
    return out


def _c(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device)


def expj(theta: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(theta), theta)


@contextlib.contextmanager
def _float32_products():
    """Matrix products in float32 (no TF32) for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Detections:
    mask: torch.Tensor
    start: torch.Tensor  # int64
    gamma: torch.Tensor
    dphi: torch.Tensor
    phi: torch.Tensor
    tau: torch.Tensor


def correlate(x: torch.Tensor, inv_es: float, q: Precision):
    """Per lag t: rho2 = max_f |c_f[t]|^2 inv_es / E[t], the first maximising
    bin, c at that bin and E[t] = sum |x[t .. t+127]|^2 (zeros past the end)."""
    tm = _c(templates(), x.device)
    l = fr.TEMPLATE_LEN
    b, t = x.shape
    xp = torch.nn.functional.pad(x, (0, l - 1))
    tc = torch.conj(tm).T.contiguous()
    rows_per = max(1, (1 << 27) // (t * l))
    out = {"rho2": [], "fbin": [], "corr": [], "energy": []}
    for r0 in range(0, b, rows_per):
        win = xp[r0 : r0 + rows_per].unfold(-1, l, 1)
        c = win @ tc
        en = torch.sum(win.real**2 + win.imag**2, dim=-1)
        mag2 = c.real**2 + c.imag**2
        best, fb = torch.max(mag2, dim=-1)
        out["rho2"].append(best * inv_es / torch.clamp(en, min=1e-12))
        out["fbin"].append(fb)
        out["corr"].append(torch.gather(c, -1, fb[..., None])[..., 0])
        out["energy"].append(en)
    return {k: q(torch.cat(v)) if k != "fbin" else torch.cat(v) for k, v in out.items()}


def detect(x: torch.Tensor, k: int, threshold: float, q: Precision) -> Detections:
    """Top-``k`` preamble hits of [B, T]: a peak must be its 128-sample
    block's maximum and not below either neighbouring block's, above
    threshold^2; ties in score go to the earlier block."""
    b, t = x.shape
    es = float(np.sum(np.abs(_template_of(0.0)) ** 2))
    red = correlate(x, 1.0 / es, q)
    energy = red["energy"]
    rho2 = torch.where(energy > 1e-9, red["rho2"], torch.zeros_like(energy))
    blk = fr.TEMPLATE_LEN
    nb = -(-t // blk)
    rb = torch.nn.functional.pad(rho2, (0, nb * blk - t), value=-1.0).reshape(b, nb, blk)
    bm, am = torch.max(rb, dim=-1)
    ninf = torch.full((b, 1), float("-inf"), dtype=bm.dtype, device=x.device)
    left, right = torch.cat([ninf, bm[:, :-1]], 1), torch.cat([bm[:, 1:], ninf], 1)
    is_peak = (bm >= left) & (bm >= right) & (bm > threshold * threshold)
    score = torch.where(is_peak, bm, torch.full_like(bm, -1.0))
    order = torch.sort(score, dim=-1, descending=True, stable=True)
    top, bstart = order.values[:, :k], order.indices[:, :k]
    start = torch.clamp(bstart * blk + torch.gather(am, 1, bstart), max=t - 1)
    fbin = torch.gather(red["fbin"], 1, start)
    cpk = torch.gather(red["corr"], 1, start)
    epk = torch.gather(energy, 1, start)
    ti = torch.clamp(start, 1, t - 2)
    ym, y0, yp = (torch.gather(rho2, 1, ti + d) for d in (-1, 0, 1))
    den = ym - 2 * y0 + yp
    tau = torch.clamp(torch.where(torch.abs(den) > 1e-12, 0.5 * (ym - yp) / den,
                                  torch.zeros_like(den)), -0.5, 0.5)
    bins = _c(np.array([2.0 * np.pi * bb / (2 * fr.TEMPLATE_LEN) for bb in CFO_BINS],
                       np.float32), x.device)
    return Detections(mask=top > 0, start=start,
                      gamma=q(torch.sqrt(torch.clamp(epk, min=1e-12) / es)),
                      dphi=bins[fbin], phi=q(torch.angle(cpk)), tau=q(tau))


def windows(x: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """[B, K, n] samples from each start (zeros outside the row)."""
    t = x.shape[-1]
    idx = start[..., None] + torch.arange(n, device=x.device)
    valid = (idx >= 0) & (idx < t)
    b, k = start.shape
    got = torch.gather(x, 1, idx.clamp(0, t - 1).reshape(b, k * n)).reshape(b, k, n)
    return torch.where(valid, got, torch.zeros_like(got))


def fine_cfo(pre: torch.Tensor, coarse: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Phase slope between the halves of the preamble window's correlation
    with the template delayed by the detector's tau, after the coarse bin."""
    bank = _c(delayed_templates(), pre.device)
    qi = torch.clamp(torch.round(tau * TAU_BANK_PHASES).to(torch.int64),
                     -TAU_BANK_RANGE, TAU_BANK_RANGE) + TAU_BANK_RANGE
    s = bank[qi]
    half = fr.TEMPLATE_LEN // 2
    n = torch.arange(fr.TEMPLATE_LEN, dtype=torch.float32, device=pre.device)
    wd = pre * expj(-coarse[..., None] * n)
    c1 = torch.sum(wd[..., :half] * torch.conj(s[..., :half]), dim=-1)
    c2 = torch.sum(wd[..., half:] * torch.conj(s[..., half:]), dim=-1)
    return torch.angle(c2 * torch.conj(c1)) / half


def recover(win: torch.Tensor, det: Detections, n_syms: int) -> torch.Tensor:
    """Derotate by dphi n + phi, divide by gamma, filter with the tau row of
    the timing bank and keep every second output: [B, K, n_syms]."""
    half = NUM_TIMING_PHASES // 2
    qi = torch.clamp(torch.round(-det.tau * NUM_TIMING_PHASES).to(torch.int64), -half, half) + half
    taps = _c(timing_bank30(), win.device)[qi]
    wr, wi = win.real, win.imag
    m = torch.arange(win.shape[-1], dtype=torch.float32, device=win.device)
    th = det.dphi[..., None] * m + det.phi[..., None]
    c, s = torch.cos(th), torch.sin(th)
    ig = (1.0 / torch.clamp(det.gamma, min=1e-9))[..., None]
    dr, di = (wr * c + wi * s) * ig, (wi * c - wr * s) * ig
    yr = torch.zeros(win.shape[:-1] + (n_syms,), dtype=torch.float32, device=win.device)
    yi = torch.zeros_like(yr)
    for v in range(fr.PULSE_LEN + 1):
        tv = taps[..., v, None]
        yr = yr + dr[..., v : v + 2 * n_syms : 2] * tv
        yi = yi + di[..., v : v + 2 * n_syms : 2] * tv
    return torch.complex(yr, yi)


# ---------------------------------------------------------------------------
# QPSK, Golay, CRC, Viterbi
# ---------------------------------------------------------------------------


def qpsk_table(device) -> torch.Tensor:
    return _c(tx.QPSK, device)


def demod_hard(r: torch.Tensor) -> torch.Tensor:
    """Nearest QPSK index (first maximum of Re(r conj c) - |c|^2 / 2)."""
    t = qpsk_table(r.device)
    score = r.real[..., None] * t.real + r.imag[..., None] * t.imag - 0.5 * torch.abs(t) ** 2
    return torch.argmax(score, dim=-1)


def index_bits(idx: torch.Tensor) -> torch.Tensor:
    return torch.stack([(idx >> 1) & 1, idx & 1], dim=-1).reshape(idx.shape[:-1] + (-1,))


def golay_decode(bits: torch.Tensor) -> torch.Tensor:
    """[..., 24 n] hard bits -> [..., 12 n] corrected data bits."""
    c = bits.reshape(bits.shape[:-1] + (-1, 24)).to(torch.int64)
    d, p = c[..., :12], c[..., 12:]
    b = _c(tx.golay_b().astype(np.float32), bits.device)  # sums of 12 ones at most: exact
    s = torch.remainder(d.to(torch.float32) @ b, 2.0).to(torch.int64) ^ p
    e = _c(golay_syndrome_table(), bits.device)[(s * (1 << torch.arange(12, device=bits.device))).sum(-1)]
    return (d ^ e).reshape(bits.shape[:-1] + (-1,))


def crc_ok(msg: torch.Tensor) -> torch.Tensor:
    tail = msg[..., -3:].to(torch.int64)
    return tx.crc24(msg[..., :-3]) == (tail[..., 0] << 16) | (tail[..., 1] << 8) | tail[..., 2]


def viterbi(lam: torch.Tensor) -> torch.Tensor:
    """[F, steps, 2] LLR pairs -> [F, steps] bits: add-compare-select from
    state 0 (cand = (m[pred] + l0 e0) + l1 e1; the second predecessor only
    where strictly larger; the best metric subtracted each step), traceback
    from state 0."""
    f, steps, _ = lam.shape
    dev = lam.device
    s = torch.arange(64, device=dev)
    p0, p1 = s >> 1, (s >> 1) | 32
    e = _c(viterbi_signs(), dev)
    m = torch.full((f, 64), -1e9, dtype=torch.float32, device=dev)
    m[:, 0] = 0.0
    dec = torch.empty((steps, f, 64), dtype=torch.bool, device=dev)
    for t in range(steps):
        l0, l1 = lam[:, t, 0:1], lam[:, t, 1:2]
        c0 = m[:, p0] + l0 * e[:, 0] + l1 * e[:, 1]
        c1 = m[:, p1] + l0 * e[:, 2] + l1 * e[:, 3]
        take = c1 > c0
        m = torch.where(take, c1, c0)
        m = m - torch.max(m, dim=1, keepdim=True).values
        dec[t] = take
    state = torch.zeros(f, dtype=torch.int64, device=dev)
    bits = torch.empty((f, steps), dtype=torch.int64, device=dev)
    for t in range(steps - 1, -1, -1):
        d = torch.gather(dec[t], 1, state[:, None])[:, 0]
        bits[:, t] = state & 1
        state = (state >> 1) | (d.to(torch.int64) * 32)
    return bits


# ---------------------------------------------------------------------------
# equaliser and carrier
# ---------------------------------------------------------------------------


def _bf16_round(a: torch.Tensor) -> torch.Tensor:
    """The Gram products' operand rounding, part of the receiver's algorithm."""
    return a.to(torch.bfloat16).to(torch.float32)


def solve_hermitian(g: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Conjugate gradients, 8 steps, on the Hermitian positive system."""
    x = torch.zeros_like(rhs)
    r, p = rhs, rhs
    rs = torch.sum(torch.abs(r) ** 2, dim=-1)
    for _ in range(g.shape[-1]):
        gp = torch.einsum("...ij,...j->...i", g, p)
        den = torch.clamp(torch.sum(torch.conj(p) * gp, dim=-1).real, min=1e-30)
        alpha = (rs / den).to(g.dtype)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * gp
        rs_new = torch.sum(torch.abs(r) ** 2, dim=-1)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)).to(g.dtype)[..., None] * p
        rs = rs_new
    return x.to(torch.complex64)


def eq_train(syms: torch.Tensor, ref: torch.Tensor | None) -> torch.Tensor:
    """Equaliser taps [..., 8] from known symbols (``None``: the preamble):
    a ridge LS channel estimate, a James-Stein gate on its ISI taps, the
    MMSE inverse, unit gain, and the identity where the fit explains less
    than 40 % of the power."""
    L, c = EQ_TAPS, EQ_TAPS // 2
    n0 = L - 1 - c
    dev = syms.device
    if ref is None:
        a_np, d_np, p_train_f, rows = preamble_estimator()
        y = syms[..., n0 : n0 + rows]
        h = y @ _c(a_np, dev).T
        resid = y - h @ _c(d_np, dev).T
        p_train = torch.full((), p_train_f, dtype=torch.float32, device=dev)
    else:
        n_ref = ref.shape[-1]
        rows = n_ref - L + 1
        y = syms[..., n0 : n0 + rows]
        rb = ref.expand(syms.shape[:-1] + (n_ref,))
        d = torch.stack([rb[..., n0 + c - t : n0 + c - t + rows] for t in range(L)], dim=-1)
        dr, di = _bf16_round(d.real), _bf16_round(d.imag)
        mm = lambda a, b: torch.einsum("...nl,...nm->...lm", a, b)
        g = torch.complex(mm(dr, dr) + mm(di, di), mm(dr, di) - mm(di, dr))
        yr, yi = _bf16_round(y.real), _bf16_round(y.imag)
        mv = lambda a, b: torch.einsum("...nl,...n->...l", a, b)
        rhs = torch.complex(mv(dr, yr) + mv(di, yi), mv(dr, yi) - mv(di, yr))
        lam = EQ_LAM_REL * torch.clamp(torch.mean(torch.diagonal(g, dim1=-2, dim2=-1).real, -1),
                                       min=1e-12)
        g = g + lam[..., None, None] * torch.eye(L, dtype=g.dtype, device=dev)
        h = solve_hermitian(g, rhs)
        resid = y - torch.einsum("...nl,...l->...n", d, h)
        p_train = torch.clamp(torch.mean(torch.abs(rb) ** 2, dim=-1), min=1e-12)
    sigma2 = torch.mean(torch.abs(resid) ** 2, dim=-1) * (rows / max(rows - L, 1))
    delta = _c(np.eye(L, dtype=np.complex64)[c], dev)
    hc = h[..., c]
    e = h - hc[..., None] * delta
    isi = torch.sum(torch.abs(e) ** 2, dim=-1)
    null = sigma2 * ((L - 1) / rows) / p_train
    kappa = torch.clamp(1.0 - null / torch.clamp(isi, min=1e-20), 0.0, 1.0)
    h = hc[..., None] * delta + kappa[..., None].to(h.dtype) * e
    lead = h.shape[:-1]
    z = lambda n: torch.zeros(lead + (n,), dtype=h.dtype, device=dev)
    hp = torch.cat([z(L), h, z(2 * L - 1)], dim=-1)
    r = torch.stack([torch.sum(hp[..., L : 3 * L] * torch.conj(hp[..., L - k : 3 * L - k]), -1)
                     for k in range(-(L - 1), L)], dim=-1)
    toep = _c(np.subtract.outer(np.arange(L), np.arange(L)) + L - 1, dev)
    m = (p_train[..., None, None] * r[..., toep]
         + sigma2[..., None, None] * torch.eye(L, dtype=h.dtype, device=dev))
    hbar = torch.flip(hp[..., 2 * c + 1 : 2 * c + 1 + L], dims=(-1,))
    w = solve_hermitian(m, p_train[..., None] * torch.conj(hbar))
    g0 = torch.sum(w * hbar, dim=-1)
    g0a = torch.abs(g0)
    g0 = torch.where(g0a > 1e-3, g0 / g0a, torch.ones_like(g0)) * torch.clamp(g0a, 0.5, 2.0)
    w = w / g0[..., None]
    return torch.where((sigma2 > 0.6 * p_train)[..., None], delta, w).to(torch.complex64)


def eq_apply(w: torch.Tensor, syms: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """z[n] = sum_t w[t] syms[n + 4 - t] (zeros outside), first ``n_out``."""
    L, c = EQ_TAPS, EQ_TAPS // 2
    n = syms.shape[-1]
    n_out = n if n_out is None else n_out
    lead = syms.shape[:-1]
    z = lambda k: torch.zeros(lead + (k,), dtype=syms.dtype, device=syms.device)
    qs = torch.cat([z(L - 1 - c), syms, z(max(0, n_out + c - n))], dim=-1)
    out = torch.zeros(lead + (n_out,), dtype=torch.complex64, device=syms.device)
    for t in range(L):
        out = out + w[..., t, None] * qs[..., L - 1 - t : L - 1 - t + n_out]
    return out


def _pow4(z: torch.Tensor) -> torch.Tensor:
    z2 = z * z
    return z2 * z2


def vv_stat(r: torch.Tensor) -> torch.Tensor:
    """(r / |r|)^4 |r|: the fourth-power statistic of QPSK."""
    mag = torch.abs(r)
    return _pow4(r / torch.clamp(mag, min=1e-12)) * mag


def _qpsk_moment():
    t = tx.QPSK
    moment = np.mean((t / np.maximum(np.abs(t), 1e-12)) ** 4 * np.abs(t))
    return moment, float(np.angle(moment))


def carrier_fit(syms: torch.Tensor, pre_ref: torch.Tensor):
    """(phi_b, dphi) through the preamble's phase and the header's
    fourth-power phase, its pi/2 fold resolved by the header's own slope."""
    h0, hn = fr.PREAMBLE_SYMS, fr.HEADER_SYMS
    h1 = h0 + hn
    qv = syms[..., :h0] * torch.conj(pre_ref)
    phi_a = torch.angle(torch.sum(qv[..., : h0 // 2], -1) + torch.sum(qv[..., h0 // 2 :], -1))
    n_a = (h0 - 1) / 2.0
    u = vv_stat(syms[..., h0:h1])
    half = hn // 2
    u1, u2 = torch.sum(u[..., :half], -1), torch.sum(u[..., half:], -1)
    slope = torch.angle(u2 * torch.conj(u1)) / (4.0 * half)
    _, psi = _qpsk_moment()
    n_b = h0 + (hn - 1) / 2.0
    phi_b = torch.angle((u1 + u2) * complex(np.exp(-1j * psi))) / 4.0
    pred = phi_a + slope * (n_b - n_a)
    phi_b = phi_b + (np.pi / 2.0) * torch.round((pred - phi_b) / (np.pi / 2.0))
    return phi_b, (phi_b - phi_a) / (n_b - n_a)


def apply_carrier(syms: torch.Tensor, phi_b: torch.Tensor, dphi: torch.Tensor) -> torch.Tensor:
    n_b = fr.PREAMBLE_SYMS + (fr.HEADER_SYMS - 1) / 2.0
    n = torch.arange(syms.shape[-1], dtype=torch.float32, device=syms.device)
    return syms * expj(-(phi_b[..., None] + dphi[..., None] * (n - n_b)))


def _median_last(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[-1]
    s = torch.sort(a, dim=-1).values
    if n % 2:
        return s[..., n // 2 : n // 2 + 1]
    return s[..., n // 2 - 1 : n // 2] * 0.5 + s[..., n // 2 : n // 2 + 1] * 0.5


def phase_track(pay: torch.Tensor, seg: int, anchor=0.0, anchor_slope=0.0):
    """QPSK carrier tracking by segments of ``seg`` symbols: the fourth-power
    phase of each segment (1-2-1 smoothed, detrended), chained from
    ``anchor`` by the predicted slope and gated by confidence, interpolated
    between segment centres; then one decision-directed complex-gain pass a
    segment. Returns (symbols, the per-symbol gain magnitude)."""
    dev = pay.device
    period, m = np.pi / 2, 4
    _, psi = _qpsk_moment()
    unpsi = complex(np.exp(-1j * psi))
    n = pay.shape[-1]
    nseg = -(-n // seg)
    lead = pay.shape[:-1]
    p = torch.cat([pay, torch.zeros(lead + (nseg * seg - n,), dtype=pay.dtype, device=dev)], -1)
    p = p.reshape(lead + (nseg, seg))
    u = torch.sum(vv_stat(p), dim=-1)
    conf = torch.abs(u)
    thr = 0.35 * _median_last(conf)
    f32 = lambda v: v.to(torch.float32) if isinstance(v, torch.Tensor) else torch.full(
        (), v, dtype=torch.float32, device=dev)
    anchor = f32(anchor)
    slope = (f32(anchor_slope) * seg).expand(lead)
    half_p = period / 2.0

    def th_at(i, slope):
        us = u[..., i]
        rot = expj(m * slope)
        if i > 0:
            us = us + 0.5 * u[..., i - 1] * rot
        if i + 1 < nseg:
            us = us + 0.5 * u[..., i + 1] * torch.conj(rot)
        return torch.angle(us * unpsi) / m

    th0 = th_at(0, slope)
    th0 = th0 - torch.round((th0 - anchor) / period) * period
    th = [th0]
    good = conf[..., 0] > thr[..., 0]
    ref = torch.where(good, th0, anchor.expand(th0.shape))
    for i in range(1, nseg):
        raw = th_at(i, slope)
        th_i = raw - torch.round((raw - (ref + slope)) / period) * period
        th.append(th_i)
        good_i = conf[..., i] > thr[..., 0]
        inc = torch.clamp(th_i - ref, -1.2 * half_p, 1.2 * half_p)
        slope = torch.where(good & good_i, 0.5 * slope + 0.5 * inc, slope)
        ref = torch.where(good_i, th_i, ref + slope)
        good = good_i
    th = torch.stack(th, dim=-1)
    t_pos = (np.arange(nseg * seg, dtype=np.float32) - (seg - 1) / 2.0) / seg
    j_lo = np.clip(np.floor(t_pos).astype(np.int64), 0, nseg - 2)
    frac = _c(np.clip(t_pos - j_lo, 0.0, 1.0).astype(np.float32), dev)
    j_lo = _c(j_lo, dev)
    phi = th[..., j_lo] * (1.0 - frac) + th[..., j_lo + 1] * frac
    flat = p.reshape(lead + (nseg * seg,)) * expj(-phi)
    # one decision-directed complex-gain pass a segment
    table = qpsk_table(dev)
    valid = _c((np.arange(nseg * seg) < n).reshape(nseg, seg).astype(np.float32), dev)
    pp = flat.reshape(lead + (nseg, seg))
    d = table[demod_hard(pp)] * valid
    e = torch.sum(pp * torch.conj(d), dim=-1)
    pd = torch.clamp(torch.sum(torch.abs(d) ** 2, dim=-1), min=1e-12)
    g = e / pd
    ga = torch.abs(g)
    g = torch.where(ga > 1e-6, g / ga, torch.ones_like(g)) * torch.clamp(ga, 0.25, 4.0)
    flat = (pp / g[..., None]).reshape(lead + (nseg * seg,))
    w = torch.repeat_interleave(torch.clamp(torch.abs(e) / pd, 1e-3, 4.0), seg, dim=-1)[..., :n]
    return flat[..., :n], w


def decode_headers(regions: list[torch.Tensor]):
    """Header symbol streams [..., 180] each -> (valid, header bytes) [..., W]
    and [..., W, 22]."""
    cat = torch.cat(regions, dim=-1)
    bits = golay_decode(index_bits(demod_hard(cat)))
    per = fr.HEADER_SYMS
    hdr = torch.stack([tx.bits_to_bytes(bits[..., b * per : b * per + fr.HEADER_BITS])
                       for b in range(len(regions))], dim=-2)
    return crc_ok(hdr), hdr


# ---------------------------------------------------------------------------
# the receiver
# ---------------------------------------------------------------------------


def decode_block(x: torch.Tensor, cfg: fr.Config, k: int, q: Precision) -> dict[str, torch.Tensor]:
    """[B, T] samples -> the receiver's fields, [B, k] slots: mask,
    header_valid, payload_valid, modulation, inner_code, outer_code,
    payload_len, header_user [B, k, 14], payload [B, k, payload_len], evm and
    rssi (dB), cfo (rad/sample), start (int64)."""
    with _float32_products():
        return _decode_block(q(x.to(torch.complex64)), cfg, k, q)


def _decode_block(x, cfg, k, q):
    dev = x.device
    h0 = fr.PREAMBLE_SYMS
    h1 = h0 + fr.HEADER_SYMS
    n_syms = cfg.frame_syms
    det = detect(x, k, cfg.threshold, q)
    win = q(windows(x, det.start, fr.K_SAMP * n_syms + fr.PULSE_TAIL))
    det.dphi = q(det.dphi + fine_cfo(win[..., : fr.TEMPLATE_LEN], det.dphi, det.tau))
    syms = q(recover(win, det, n_syms))

    pre_ref = _c(tx.preamble_symbols(), dev)
    w1 = q(eq_train(syms, None))
    c = EQ_TAPS // 2
    hdr_region = q(eq_apply(w1, syms[..., : h1 + c], n_out=h1))
    raw_region = syms[..., :h1]
    qp1 = torch.sum(hdr_region[..., h0 - 32 : h0 - 16] * torch.conj(pre_ref[-32:-16]), -1)
    qp2 = torch.sum(hdr_region[..., h0 - 16 : h0] * torch.conj(pre_ref[-16:]), -1)
    slope_pre = torch.angle(qp2 * torch.conj(qp1)) / 16.0
    anchor_pre = torch.angle(qp2) + slope_pre * (8.0 + 9.0)
    hdr_pre_fit = hdr_region
    fit_eq, fit_raw = carrier_fit(hdr_region, pre_ref), carrier_fit(syms, pre_ref)
    hdr_region = apply_carrier(hdr_region, *fit_eq)
    raw_region = apply_carrier(raw_region, *fit_raw)
    hdr_trk, _ = phase_track(hdr_pre_fit[..., h0:h1], 18, anchor_pre, slope_pre)
    v3, hb3 = decode_headers([hdr_region[..., h0:h1], raw_region[..., h0:h1], q(hdr_trk)])
    v_eq, v_raw = v3[..., 0], v3[..., 1]
    hdr_valid = v_eq | v_raw | v3[..., 2]
    p_raw = (~v_eq) & v_raw
    hdr = torch.where(v_eq[..., None], hb3[..., 0, :],
                      torch.where(p_raw[..., None], hb3[..., 1, :], hb3[..., 2, :]))
    use_eq = v_eq | (~p_raw)
    syms = apply_carrier(syms, torch.where(use_eq, fit_eq[0], fit_raw[0]),
                         torch.where(use_eq, fit_eq[1], fit_raw[1]))
    hdr_ref = tx.header_symbols(hdr)
    refs = torch.cat([pre_ref.expand(hdr_ref.shape[:-1] + (h0,)), hdr_ref], dim=-1)
    w = torch.where(hdr_valid[..., None], q(eq_train(syms, refs)), w1)
    syms = q(eq_apply(w, syms))
    hs = syms[..., h0:h1]
    evm_lin = q(torch.mean(torch.abs(hs - qpsk_table(dev)[demod_hard(hs)]) ** 2, dim=-1))

    # payload: anchor from the header re-encoded, tracker, soft bits, decode
    u1 = torch.sum(syms[..., h0 : h0 + 90] * torch.conj(hdr_ref[..., :90]), -1)
    u2 = torch.sum(syms[..., h0 + 90 : h1] * torch.conj(hdr_ref[..., 90:]), -1)
    a_slope = torch.clamp(torch.angle(u2 * torch.conj(u1)) / 90.0, -0.025, 0.025)
    q2 = torch.sum(syms[..., h1 - 20 : h1] * torch.conj(hdr_ref[..., -20:]), -1)
    anchor = torch.angle(q2) + a_slope * 10.0
    pay = syms[..., h1 : h1 + cfg.payload_syms]
    t_rel = torch.arange(pay.shape[-1], dtype=torch.float32, device=dev)
    pay = pay * expj(-(anchor[..., None] + a_slope[..., None] * t_rel))
    pay, gmag = phase_track(pay, 32)
    pay = q(pay)
    nv = torch.clamp(evm_lin, min=1e-4)[..., None] / torch.square(gmag)
    d2 = torch.abs(pay[..., None] - qpsk_table(dev)) ** 2  # [..., n, 4]
    llr = torch.stack([torch.minimum(d2[..., 2], d2[..., 3]) - torch.minimum(d2[..., 0], d2[..., 1]),
                       torch.minimum(d2[..., 1], d2[..., 3]) - torch.minimum(d2[..., 0], d2[..., 2])],
                      dim=-1) / nv[..., None]
    llr = q(llr.reshape(llr.shape[:-2] + (-1,))[..., : cfg.inner_bits])
    inv = np.argsort(fr.interleave_perm(cfg.inner_bits))  # llr of bit j sits at inv[j]
    llr = llr[..., _c(inv, dev)]
    if cfg.inner_code == 1:
        lead = llr.shape[:-1]
        steps = cfg.outer_bits + fr.V27_TAIL
        obits = viterbi(llr.reshape(-1, steps, 2))[:, : cfg.outer_bits].reshape(
            lead + (cfg.outer_bits,))
    else:
        obits = (llr[..., : cfg.outer_bits] < 0).to(torch.int64)
    if cfg.outer_code == 1:
        obits = golay_decode(obits)
    msg = tx.bits_to_bytes(obits[..., : 8 * cfg.msg_bytes])
    ok = crc_ok(msg)

    mod, inner, outer = (hdr[..., i].to(torch.int32) for i in (16, 17, 18))
    plen = (hdr[..., 14].to(torch.int32) << 8) | hdr[..., 15].to(torch.int32)
    match = ((mod == cfg.modulation) & (inner == cfg.inner_code) & (outer == cfg.outer_code)
             & (plen == cfg.payload_len))
    return {
        "mask": det.mask,
        "header_valid": hdr_valid & det.mask,
        "payload_valid": ok & hdr_valid & match & det.mask,
        "modulation": mod, "inner_code": inner, "outer_code": outer, "payload_len": plen,
        "header_user": hdr[..., : fr.HEADER_USER_BYTES],
        "payload": msg[..., : cfg.payload_len],
        "evm": 10.0 * torch.log10(torch.clamp(evm_lin, min=1e-12)),
        "rssi": 20.0 * torch.log10(torch.clamp(det.gamma, min=1e-12)),
        "cfo": det.dphi,
        "start": det.start,
    }
