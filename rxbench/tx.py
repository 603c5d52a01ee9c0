"""The benchmark's own transmitter and channel, in plain PyTorch.

A frozen copy of the flexframe transmitter for the chains ``frame.Config``
allows (written from the port's TX, which it must equal bit for bit, and
from the format in ``frame.py``): CRC-24, Golay(24,12), V27, the bit
interleaver, QPSK, the preamble m-sequence and the RRC interpolator. It
imports nothing of the program. ``make_pool`` lays the frames of a cyclic
stream out on the device from the seed, with a carrier phase and offset per
channel and AWGN, in a few large calls.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from rxbench import frame as fr

CRC24_POLY = 0x864CFB
CRC24_INIT = 0xB704CE
V27_G = (0o133, 0o171)


# ---------------------------------------------------------------------------
# constant tables (numpy, built once)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def preamble_symbols() -> np.ndarray:
    """64 QPSK symbols of the m-sequence of x^7 + x^3 + 1 from state 1: two
    successive bits a symbol, real then imaginary, 1 -> +1/sqrt(2)."""
    v, taps, out = 1, 0x0089 >> 1, []
    for _ in range(2 * fr.PREAMBLE_SYMS):
        b = bin(v & taps).count("1") & 1
        out.append(b)
        v = ((v << 1) | b) & 0x7F
    bits = np.array(out, dtype=np.float32)
    s = np.float32(1.0 / np.sqrt(2.0))
    return (np.where(bits[0::2] > 0, s, -s) + 1j * np.where(bits[1::2] > 0, s, -s)).astype(
        np.complex64)


def rrc_taps(dt: float = 0.0, k: int = 2, m: int = 7, beta: float = 0.3) -> np.ndarray:
    """Root-raised-cosine pulse of 2 k m + 1 taps, unit energy, delayed by
    ``dt`` samples."""
    n = np.arange(-k * m, k * m + 1, dtype=np.float64) - dt
    t = n / k
    h = np.empty_like(t)
    eps = 1e-9
    t0 = np.abs(t) < eps
    ts = np.abs(np.abs(t) - 1.0 / (4.0 * beta)) < eps
    tn = ~(t0 | ts)
    tt = t[tn]
    h[tn] = (np.sin(np.pi * tt * (1.0 - beta)) + 4.0 * beta * tt * np.cos(np.pi * tt * (1.0 + beta))
             ) / (np.pi * tt * (1.0 - (4.0 * beta * tt) ** 2))
    h[t0] = 1.0 - beta + 4.0 * beta / np.pi
    h[ts] = (beta / np.sqrt(2.0)) * ((1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                                     + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta)))
    return (h / np.sqrt(np.sum(h * h))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def golay_b() -> np.ndarray:
    """B of the extended Golay code G = [I | B]: the circulant of
    {0} u QR(11) bordered by ones, B[11, 11] = 0."""
    qr = {0, 1, 3, 4, 5, 9}
    b = np.zeros((12, 12), dtype=np.uint8)
    for i in range(11):
        for j in range(11):
            b[i, j] = 1 if ((j - i) % 11) in qr else 0
        b[i, 11] = 1
    b[11, :11] = 1
    return b


@functools.lru_cache(maxsize=None)
def crc24_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.int64)
    for byte in range(256):
        reg = byte << 16
        for _ in range(8):
            reg = ((reg << 1) ^ CRC24_POLY) if reg & 0x800000 else reg << 1
            reg &= 0xFFFFFF
        table[byte] = reg
    return table


QPSK = (np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2.0)).astype(np.complex64)


def const(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# bit-level helpers
# ---------------------------------------------------------------------------


def crc24(msg: torch.Tensor) -> torch.Tensor:
    """CRC-24/OPENPGP of uint8 [..., L] -> int64 [...], byte by byte."""
    table = const(crc24_table(), msg.device)
    reg = torch.full(msg.shape[:-1], CRC24_INIT, dtype=torch.int64, device=msg.device)
    m = msg.to(torch.int64)
    for i in range(msg.shape[-1]):
        reg = ((reg << 8) ^ table[((reg >> 16) ^ m[..., i]) & 0xFF]) & 0xFFFFFF
    return reg


def crc24_append(msg: torch.Tensor) -> torch.Tensor:
    c = crc24(msg)
    return torch.cat([msg, torch.stack([(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF], -1)
                      .to(torch.uint8)], dim=-1)


def bytes_to_bits(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., L] -> int64 bits [..., 8 L], most significant first."""
    shifts = torch.arange(7, -1, -1, device=b.device)
    return ((b.to(torch.int64)[..., None] >> shifts) & 1).reshape(b.shape[:-1] + (-1,))


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64).reshape(bits.shape[:-1] + (-1, 8)) * w).sum(-1).to(torch.uint8)


def golay_encode(bits: torch.Tensor) -> torch.Tensor:
    """[..., 12 n] bits -> [..., 24 n]: each block followed by its parity."""
    m = bits.reshape(bits.shape[:-1] + (-1, 12)).to(torch.int64)
    # sums of at most 12 ones: exact in float32
    par = torch.remainder(m.to(torch.float32) @ const(golay_b().astype(np.float32), bits.device),
                          2.0).to(torch.int64)
    return torch.cat([m, par], dim=-1).reshape(bits.shape[:-1] + (-1,))


def v27_encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 K=7 code (0o133, 0o171), six zero tail bits: [..., n] ->
    [..., 2 (n + 6)], the two outputs of a step side by side."""
    lead = bits.shape[:-1]
    z = torch.zeros(lead + (fr.V27_TAIL,), dtype=torch.int64, device=bits.device)
    pad = torch.cat([z, bits.to(torch.int64), z], dim=-1)  # u_{t-6} .. u_t at t .. t+6
    steps = bits.shape[-1] + fr.V27_TAIL
    outs = []
    for g in V27_G:
        acc = torch.zeros(lead + (steps,), dtype=torch.int64, device=bits.device)
        for tap in range(7):
            if (g >> (6 - tap)) & 1:
                acc = acc ^ pad[..., tap : tap + steps]
        outs.append(acc)
    return torch.stack(outs, dim=-1).reshape(lead + (2 * steps,))


def qpsk(bits: torch.Tensor) -> torch.Tensor:
    """Bit pairs (MSB first) -> QPSK symbols."""
    idx = bits.reshape(bits.shape[:-1] + (-1, 2)).to(torch.int64)
    return const(QPSK, bits.device)[idx[..., 0] * 2 + idx[..., 1]]


def header_symbols(header_bytes: torch.Tensor) -> torch.Tensor:
    """CRC'd header bytes [..., 22] -> 180 QPSK symbols (4 zero bits of pad,
    Golay, QPSK)."""
    bits = bytes_to_bits(header_bytes)
    pad = torch.zeros(bits.shape[:-1] + (fr.HEADER_BITS_PADDED - fr.HEADER_BITS,),
                      dtype=bits.dtype, device=bits.device)
    return qpsk(golay_encode(torch.cat([bits, pad], dim=-1)))


def header_bytes(cfg: fr.Config, user: torch.Tensor) -> torch.Tensor:
    """[..., 14] user bytes -> [..., 22] with the config fields and CRC-24."""
    proto = torch.tensor([(cfg.payload_len >> 8) & 0xFF, cfg.payload_len & 0xFF,
                          cfg.modulation, cfg.inner_code, cfg.outer_code],
                         dtype=torch.uint8, device=user.device)
    return crc24_append(torch.cat([user, proto.expand(user.shape[:-1] + (5,))], dim=-1))


def payload_symbols(cfg: fr.Config, payload: torch.Tensor) -> torch.Tensor:
    bits = bytes_to_bits(crc24_append(payload))
    if cfg.outer_code == 1:
        pad = (-bits.shape[-1]) % 12
        bits = golay_encode(torch.nn.functional.pad(bits, (0, pad)))
    if cfg.inner_code == 1:
        bits = v27_encode(bits)
    bits = bits[..., const(fr.interleave_perm(cfg.inner_bits), bits.device)]
    bits = torch.nn.functional.pad(bits, (0, 2 * cfg.payload_syms - cfg.inner_bits))
    return qpsk(bits)


def interp(syms: torch.Tensor) -> torch.Tensor:
    """Zero-stuff by 2 and 'full'-convolve with the RRC pulse: [..., n] ->
    [..., 2 n + 28] complex64."""
    taps = const(rrc_taps()[::-1].copy(), syms.device).view(1, 1, -1)
    lead, n = syms.shape[:-1], syms.shape[-1]
    up = torch.zeros(lead + (2 * n,), dtype=torch.complex64, device=syms.device)
    up[..., ::2] = syms
    planes = torch.view_as_real(up).movedim(-1, -2).reshape(-1, 1, 2 * n)
    out = torch.nn.functional.conv1d(planes, taps, padding=fr.PULSE_LEN - 1)
    out = out.reshape(lead + (2, -1)).movedim(-2, -1).contiguous()
    return torch.view_as_complex(out)


def framegen(cfg: fr.Config, payload: torch.Tensor, user: torch.Tensor) -> torch.Tensor:
    """[F, payload_len] payloads and [F, 14] user headers (uint8) -> [F,
    frame_samples] complex64 baseband."""
    pre = const(preamble_symbols(), payload.device).expand(payload.shape[0], -1)
    syms = torch.cat([pre, header_symbols(header_bytes(cfg, user)),
                      payload_symbols(cfg, payload)], dim=-1)
    return interp(syms)


# ---------------------------------------------------------------------------
# the cyclic stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Pool:
    """The stream of one run: ``chunks`` [N, B, L] complex64 and what was sent.

    ``starts`` [B, n] are the unwrapped frame starts of ``frame.Layout``;
    ``payload`` [B, n, payload_len] and ``user`` [B, n, 14] what each frame
    carries; ``cfo`` [B] rad/sample and ``phase`` [B] rad the channel's
    carrier. Host arrays except ``chunks``."""

    chunks: torch.Tensor
    layout: fr.Layout
    payload: np.ndarray
    user: np.ndarray
    cfo: np.ndarray
    phase: np.ndarray

    @property
    def n_chunks(self) -> int:
        return self.chunks.shape[0]


def make_pool(cfg: fr.Config, batch: int, chunk_len: int, n_chunks: int, seed: int,
              device: torch.device) -> Pool:
    """Draw a cyclic stream of ``n_chunks`` chunks of [batch, chunk_len] from
    ``seed`` on ``device``: a distinct payload and user header every frame,
    a carrier phase uniform in [0, 2 pi) and an offset uniform in
    [-cfo_max, cfo_max] per channel, the carrier running on through every
    frame from its unwrapped start, then complex AWGN at ``snr_db`` below the
    frames' mean power."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    circle = n_chunks * chunk_len
    layout = fr.circle_layout(cfg, batch, circle)
    n = layout.frames_per_channel
    rnd = lambda *shape: torch.randint(0, 256, shape, generator=gen, device=device,
                                       dtype=torch.int64).to(torch.uint8)
    payload, user = rnd(batch, n, cfg.payload_len), rnd(batch, n, fr.HEADER_USER_BYTES)
    unif = lambda: torch.rand(batch, generator=gen, device=device, dtype=torch.float64)
    cfo = (2.0 * unif() - 1.0) * cfg.cfo_max
    phase = 2.0 * np.pi * unif()
    frames = framegen(cfg, payload.reshape(batch * n, -1), user.reshape(batch * n, -1))
    f = frames.shape[-1]
    starts = torch.from_numpy(layout.starts).to(device)
    t = torch.arange(f, device=device, dtype=torch.float64)
    theta = phase[:, None, None] + cfo[:, None, None] * (starts[:, :, None] + t)
    rot = torch.polar(torch.ones_like(theta), torch.remainder(theta, 2.0 * np.pi))
    frames = frames.reshape(batch, n, f) * rot.to(torch.complex64)
    x = torch.zeros(batch * circle, dtype=torch.complex64, device=device)
    idx = (torch.arange(batch, device=device)[:, None, None] * circle
           + (starts[:, :, None] + torch.arange(f, device=device)) % circle)
    x[idx.reshape(-1)] = frames.reshape(-1)
    power = torch.mean(torch.abs(frames) ** 2)
    sigma = torch.sqrt(power / (2.0 * 10.0 ** (cfg.snr_db / 10.0)))
    noise = torch.complex(torch.randn(batch * circle, generator=gen, device=device),
                          torch.randn(batch * circle, generator=gen, device=device))
    x = (x + sigma * noise).reshape(batch, n_chunks, chunk_len).transpose(0, 1).contiguous()
    return Pool(x, layout, payload.cpu().numpy(), user.cpu().numpy(), cfo.cpu().numpy(),
                phase.cpu().numpy())
