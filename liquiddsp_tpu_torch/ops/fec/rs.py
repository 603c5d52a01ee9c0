"""Reed-Solomon over GF(2^8): RS(255,223), shortened (outer code index 2).

Counterpart of ``liquiddsp_tpu/ops/fec/rs.py``, the same code:

- field GF(2^8) with primitive polynomial 0x11D, generator element alpha = 2;
- RS(255,223): 32 parity bytes, corrects up to 16 byte errors per block;
  generator polynomial g(x) = prod_{i=1..32} (x - alpha^i) (fcr = 1);
- messages longer than 223 bytes are split into ceil(L/223) blocks as evenly
  as possible; each block of k_i <= 223 data bytes is encoded shortened
  (virtual leading zeros) to k_i + 32 transmitted bytes.

How it maps to a GPU. A product with a CONSTANT field element is linear over
GF(2), so every step that combines the data with constants only is one
bit-level matrix product mod 2 (float32, exact: the sums stay below 2^24):
the encoder (parity = message x the LFSR's response to each unit byte), the
32 syndromes (received word x powers of alpha) and the Chien / Forney
evaluations of the locator, its derivative and the evaluator at all n
positions at once. What is left as a loop is the Berlekamp-Massey iteration,
whose products are data x data: 32 steps of a fixed trip count with
where-masked updates on [N, 33] tensors through log/exp table gathers. No
step reads a value back to the host. One decode of a block is about 2,100
small launches whatever the batch (2,123 counted on an NVIDIA H100 by
``profile_step --sharded``), nearly all in the Berlekamp-Massey loop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from liquiddsp_tpu_torch.core.device import device_const

PRIM_POLY = 0x11D
NN = 255  # block length
KK = 223  # data bytes per full block
NROOTS = 32  # parity bytes
T = 16  # correctable byte errors


@functools.lru_cache(maxsize=None)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """exp[0..511] (doubled for index wrap) and log[0..255] tables."""
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    log[0] = 0  # by convention; zero handled via masks
    return exp, log


def _gf_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    exp, log = _tables()
    return np.where((a == 0) | (b == 0), 0, exp[log[a] + log[b]])


@functools.lru_cache(maxsize=None)
def _genpoly() -> np.ndarray:
    """Generator polynomial coefficients, ascending degree, length NROOTS+1."""
    exp, _ = _tables()
    g = np.zeros(NROOTS + 1, dtype=np.int64)
    g[0] = 1
    for i in range(1, NROOTS + 1):
        ng = _gf_mul_np(g, exp[i])  # times the root alpha^i (fcr = 1)
        ng[1:] ^= g[:-1]
        g = ng
    return g


def block_sizes(msg_len: int) -> list[int]:
    """Split a message of ``msg_len`` bytes into near-equal blocks <= KK."""
    nb = -(-msg_len // KK)
    base, rem = divmod(msg_len, nb)
    return [base + (1 if i < rem else 0) for i in range(nb)]


def encoded_len(msg_len: int) -> int:
    return msg_len + NROOTS * len(block_sizes(msg_len))


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------


def _lfsr_parity_np(msgs: np.ndarray) -> np.ndarray:
    """LFSR long division, batched over rows: msgs [N, k] -> parity [N, 32]
    in transmit order (descending degree): the remainder of
    msg(x) * x^NROOTS mod g(x)."""
    g = _genpoly()[:NROOTS]
    parity = np.zeros((msgs.shape[0], NROOTS), dtype=np.int64)
    for j in range(msgs.shape[1]):
        fb = msgs[:, j].astype(np.int64) ^ parity[:, -1]
        parity = np.concatenate([np.zeros_like(parity[:, :1]), parity[:, :-1]], axis=1)
        parity ^= _gf_mul_np(fb[:, None], g[None, :])
    return parity[:, ::-1]


def encode_host(msg: np.ndarray) -> np.ndarray:
    """Full message [L] -> concatenated shortened blocks (numpy oracle)."""
    out = []
    pos = 0
    for k in block_sizes(len(msg)):
        blk = msg[pos : pos + k].astype(np.uint8)
        out.append(np.concatenate([blk, _lfsr_parity_np(blk[None])[0].astype(np.uint8)]))
        pos += k
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# constant maps as bit matrices
# ---------------------------------------------------------------------------


def _bit_matrix(a: np.ndarray) -> np.ndarray:
    """The GF(256)-linear map out[o] = XOR_i v[i] * a[i, o] with constant
    ``a`` [m_in, m_out], as a GF(2) matrix [8 m_in, 8 m_out] float32 on bits
    (LSB first within a byte): bit b of v[i] contributes a[i, o] * 2^b."""
    m_in, m_out = a.shape
    prod = _gf_mul_np(a[:, None, :], (1 << np.arange(8))[None, :, None])  # [m_in, 8, m_out]
    bits = (prod[..., None] >> np.arange(8)) & 1  # [m_in, 8, m_out, 8]
    return bits.reshape(8 * m_in, 8 * m_out).astype(np.float32)


def _alpha_pow(e: np.ndarray) -> np.ndarray:
    exp, _ = _tables()
    return exp[np.mod(e, 255)]


def _encode_matrix(k: int) -> np.ndarray:
    """Parity bytes of each unit message byte: the encoder is linear."""
    return _bit_matrix(_lfsr_parity_np(np.eye(k, dtype=np.int64)))


def _syndrome_matrix(n: int) -> np.ndarray:
    """S_i = r(alpha^i), i = 1..32: byte p of n carries alpha^(i (n-1-p))."""
    p = np.arange(n)[:, None]
    i = np.arange(1, NROOTS + 1)[None, :]
    return _bit_matrix(_alpha_pow(i * (n - 1 - p)))


def _eval_matrix(n: int) -> np.ndarray:
    """From [Lambda (33 coefficients) | Omega (32)] to, at every position
    j' = 0..n-1 counted from the last byte, X^-1 = alpha^-j':
    [Lambda(X^-1) | Lambda'(X^-1) | Omega(X^-1)]."""
    jp = np.arange(n)[None, :]
    deg = np.arange(NROOTS + 1)[:, None]
    lam = _alpha_pow(-jp * deg)  # [33, n]
    # formal derivative in characteristic 2: odd-degree terms, one degree down
    dlam = np.where(deg % 2 == 1, _alpha_pow(-jp * (deg - 1)), 0)
    om = _alpha_pow(-jp * np.arange(NROOTS)[:, None])  # [32, n]
    a = np.zeros((2 * NROOTS + 1, 3 * n), dtype=np.int64)
    a[: NROOTS + 1, :n] = lam
    a[: NROOTS + 1, n : 2 * n] = dlam
    a[NROOTS + 1 :, 2 * n :] = om
    return _bit_matrix(a)


_BIT_SHIFTS = np.arange(8, dtype=np.int64)


def _to_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 bytes [..., m] -> float32 bits [..., 8m], LSB first."""
    sh = device_const(("rs_shifts",), lambda: _BIT_SHIFTS, v.device)
    return ((v[..., None] >> sh) & 1).reshape(v.shape[:-1] + (8 * v.shape[-1],)).to(torch.float32)


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    """Bits [..., 8m] (any integer-valued type) -> int64 bytes [..., m]."""
    sh = device_const(("rs_shifts",), lambda: _BIT_SHIFTS, b.device)
    b = b.to(torch.int64).reshape(b.shape[:-1] + (b.shape[-1] // 8, 8))
    return torch.sum(b << sh, dim=-1)


def _gf_linear(v: torch.Tensor, key: tuple, build) -> torch.Tensor:
    """Apply the constant map ``build()`` (a ``_bit_matrix``) to bytes v."""
    m = device_const(key, build, v.device)
    return _from_bits(torch.remainder(_to_bits(v) @ m, 2.0))


def _xor_reduce(v: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis of int64 bytes (torch has no such reduction):
    the parity of each bit plane's sum."""
    sh = device_const(("rs_shifts",), lambda: _BIT_SHIFTS, v.device)
    planes = torch.sum((v[..., None] >> sh) & 1, dim=-2) & 1
    return torch.sum(planes << sh, dim=-1)


def _gf_mul(a: torch.Tensor, b: torch.Tensor, exp: torch.Tensor, log: torch.Tensor):
    r = exp[log[a] + log[b]]  # the doubled exp table takes the wrap
    return torch.where((a == 0) | (b == 0), torch.zeros_like(r), r)


def _gf_inv(a: torch.Tensor, exp: torch.Tensor, log: torch.Tensor) -> torch.Tensor:
    """1/a; a zero is taken as 1."""
    return exp[(255 - log[torch.clamp(a, min=1)]) % 255]


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def encode_block(msg: torch.Tensor) -> torch.Tensor:
    """msg [..., k] uint8 (k <= KK) -> [..., k + 32] uint8."""
    k = msg.shape[-1]
    parity = _gf_linear(msg.to(torch.int64), ("rs_enc", k), lambda: _encode_matrix(k))
    return torch.cat([msg, parity.to(torch.uint8)], dim=-1)


def decode_block(code: torch.Tensor, k: int) -> torch.Tensor:
    """code [..., k+32] uint8 -> corrected data [..., k] uint8.

    Berlekamp-Massey + Chien + Forney, all fixed control flow. Shortened
    block: positions are indexed as if padded to 255 with leading zeros. A
    block with more than 16 errors comes back as received, or miscorrected
    where the locator happens to have roots, exactly as in the JAX package.
    """
    dev = code.device
    exp_np, log_np = _tables()
    exp = device_const(("rs_exp",), lambda: exp_np, dev)
    log = device_const(("rs_log",), lambda: log_np, dev)
    n = k + NROOTS
    batch_shape = code.shape[:-1]
    r = code.reshape((-1, n)).to(torch.int64)
    b = r.shape[0]

    syn = _gf_linear(r, ("rs_syn", n), lambda: _syndrome_matrix(n))  # [B, 32]
    no_errors = torch.all(syn == 0, dim=1)

    # --- Berlekamp-Massey (fixed NROOTS iterations, masked updates) ---
    # c: error locator (ascending, length 33), bb: previous locator,
    # el: current L, bmv: last discrepancy, m: shift count x^m
    t2 = NROOTS + 1
    jj = torch.arange(t2, device=dev)
    c = torch.zeros((b, t2), dtype=torch.int64, device=dev)
    c[:, 0] = 1
    bb = c.clone()
    el = torch.zeros((b,), dtype=torch.int64, device=dev)
    bmv = torch.ones((b,), dtype=torch.int64, device=dev)
    m = torch.ones((b,), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(NROOTS):
        # discrepancy d = XOR_{j=0..L} c[j] * S[i-j]
        sidx = i - jj
        valid = (sidx >= 0) & (jj <= el[:, None])
        s_j = torch.where(valid, syn[:, torch.clamp(sidx, 0, NROOTS - 1)], zero)
        d = _xor_reduce(_gf_mul(c, s_j, exp, log))
        d_zero = d == 0
        coef = _gf_mul(d, _gf_inv(bmv, exp, log), exp, log)  # d / b
        # bb * x^m
        idx = jj[None, :] - m[:, None]
        xb = torch.where(idx >= 0, torch.gather(bb, 1, torch.clamp(idx, 0, t2 - 1)), zero)
        c_new = c ^ _gf_mul(coef[:, None], xb, exp, log)
        grow = (~d_zero) & (2 * el <= i)
        bb = torch.where(grow[:, None], c, bb)
        c = torch.where(d_zero[:, None], c, c_new)
        m = torch.where(grow, torch.ones_like(m), m + 1)
        bmv = torch.where(grow, d, bmv)
        el = torch.where(grow, i + 1 - el, el)

    # --- Forney's evaluator Omega(x) = [S(x) Lambda(x)] mod x^NROOTS ---
    # omega[dd] = XOR_{j<=dd} S[dd-j] * c[j]
    sidx = torch.arange(NROOTS, device=dev)[:, None] - jj[None, :]  # [32, 33]
    s_terms = torch.where(sidx >= 0, syn[:, torch.clamp(sidx, 0, NROOTS - 1)], zero)
    omega = _xor_reduce(_gf_mul(s_terms, c[:, None, :], exp, log))  # [B, 32]

    # --- Chien search and Forney magnitudes at all n positions at once ---
    ev = _gf_linear(torch.cat([c, omega], dim=1), ("rs_eval", n), lambda: _eval_matrix(n))
    lam_val, dv_val, om_val = ev[:, :n], ev[:, n : 2 * n], ev[:, 2 * n :]
    # magnitude = X^(1-fcr) Omega(X^-1) / Lambda'(X^-1); fcr = 1: no X factor
    inv_dv = torch.where(dv_val == 0, zero, _gf_inv(dv_val, exp, log))
    mag = _gf_mul(om_val, inv_dv, exp, log)
    err = torch.where(lam_val == 0, mag, zero)  # indexed by j' (from the end)
    err = torch.flip(err, dims=(1,))  # back to transmit order
    keep = (no_errors | (el > T))[:, None]
    corrected = torch.where(keep, r, r ^ err)
    return corrected[:, :k].to(torch.uint8).reshape(batch_shape + (k,))


def encode(msg: torch.Tensor) -> torch.Tensor:
    """Message [..., L] uint8 -> shortened-block concatenation
    [..., encoded_len(L)] uint8."""
    outs = []
    pos = 0
    for k in block_sizes(msg.shape[-1]):
        outs.append(encode_block(msg[..., pos : pos + k]))
        pos += k
    return torch.cat(outs, dim=-1)


def decode(code: torch.Tensor, msg_len: int) -> torch.Tensor:
    """Coded [..., encoded_len(L)] uint8 -> corrected message [..., L] uint8."""
    outs = []
    pos = 0
    for k in block_sizes(msg_len):
        outs.append(decode_block(code[..., pos : pos + k + NROOTS], k))
        pos += k + NROOTS
    return torch.cat(outs, dim=-1)
