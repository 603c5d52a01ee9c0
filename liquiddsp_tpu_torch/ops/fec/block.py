"""Systematic GF(2) linear block codes: Hamming(7,4), Hamming(12,8),
SEC-DED(22,16)/(39,32)/(72,64), Golay(24,12).

Counterpart of ``liquiddsp_tpu/ops/fec/block.py``: the outer-FEC family
(outer codes 1 and 3-7; the header always uses Golay). The constructions are
the standard ones (shortened Hamming, Hamming plus overall parity, extended
Golay); TX and RX share them. Correction radii: 1 bit for Hamming and
SEC-DED, 3 bits for Golay.

Encode is a bit-level product with the parity matrix P (``m @ P mod 2`` in
float32, exact since row sums are tiny). Decode is a syndrome product, then
for the single-error codes one comparison of the packed syndrome against the
k data-column syndromes, and for Golay the arithmetic table-free decoder on
packed 12-bit syndromes. ``encode_host`` / ``decode_host`` are the numpy
oracle (decode by a syndrome table).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from liquiddsp_tpu_torch.core.device import device_const


def _hamming_parity_matrix(k: int, r: int) -> np.ndarray:
    """P (k x r) of the shortened Hamming code: data columns are the first k
    non-power-of-two values in 1..2**r-1."""
    cols = [v for v in range(1, 1 << r) if v & (v - 1)][:k]
    if len(cols) != k:
        raise ValueError(f"no Hamming code with {k} data and {r} parity bits")
    return np.array([[(c >> j) & 1 for j in range(r)] for c in cols], dtype=np.uint8)


def _golay_b_matrix() -> np.ndarray:
    """The 12x12 B matrix of the extended binary Golay [24,12,8] code.

    Quadratic-residue construction: the 11x11 block is the circulant of the
    indicator of {0} u QR(11) = {0,1,3,4,5,9}; bordered by a row/column of
    ones with B[11,11] = 0.
    """
    qr = {0, 1, 3, 4, 5, 9}
    b = np.zeros((12, 12), dtype=np.uint8)
    for i in range(11):
        for j in range(11):
            b[i, j] = 1 if ((j - i) % 11) in qr else 0
        b[i, 11] = 1
    b[11, :11] = 1
    b[11, 11] = 0
    return b


def _popcount12(v: torch.Tensor) -> torch.Tensor:
    """Population count of int32 values below 2^12 (SWAR; torch has no
    popcount on tensors)."""
    v = v - ((v >> 1) & 0x555)
    v = (v & 0x333) + ((v >> 2) & 0x333)
    v = (v + (v >> 4)) & 0x70F
    return (v + (v >> 8)) & 0xF


def _decode_golay_packed(s: torch.Tensor) -> torch.Tensor:
    """Arithmetic extended-Golay decoder: packed 12-bit syndrome [...] int32
    -> packed 12-bit DATA error pattern e_u (parity errors never touch data).

    The standard table-free decoder, valid because G = [I | B] is self-dual
    (B B^T = I mod 2): with e = [e_u | e_v] and s = e_u B xor e_v, exactly
    one of 26 candidates covers every coset of weight <= 3 —
      wt(s) <= 3                 -> e_u = 0
      wt(s ^ B_i) <= 2           -> e_u = delta_i          (B_i = row i of B)
      t = s B^T: wt(t) <= 3      -> e_u = t
      wt(t ^ Bcol_i) <= 2        -> e_u = t ^ Bcol_i       (e_v = delta_i)
    Distinct weight-<=3 patterns have distinct syndromes (d_min = 8), so the
    branch that fires is unique; weight-4 cosets fire no branch and return 0.
    """
    b = _golay_b_matrix().astype(np.int64)
    row_pk = [int(v) for v in b @ (1 << np.arange(12))]  # rows of B, packed
    col_pk = [int(v) for v in b.T @ (1 << np.arange(12))]  # cols of B, packed
    pc = _popcount12

    done = pc(s) <= 3
    e_u = torch.zeros_like(s)
    for i in range(12):
        hit = (~done) & (pc(s ^ row_pk[i]) <= 2)
        e_u = torch.where(hit, 1 << i, e_u)
        done = done | hit
    # t = s B^T, bit j = parity of s & (row j of B)
    t = torch.zeros_like(s)
    for j in range(12):
        t = t | ((pc(s & row_pk[j]) & 1) << j)
    hit = (~done) & (pc(t) <= 3)
    e_u = torch.where(hit, t, e_u)
    done = done | hit
    for i in range(12):
        cand = t ^ col_pk[i]
        hit = (~done) & (pc(cand) <= 2)
        e_u = torch.where(hit, cand, e_u)
        done = done | hit
    return e_u


class LinearBlockCode:
    """Systematic (n, k) binary code with G = [I_k | P], H = [P^T | I_{n-k}].

    ``max_correct`` bounds the weight of the error patterns in the host
    oracle's syndrome table (1 for Hamming/SEC-DED, 3 for Golay).
    """

    def __init__(self, name: str, p: np.ndarray, max_correct: int = 1):
        self.name = name
        self.p = p.astype(np.uint8)
        self.k, self.r = p.shape
        self.n = self.k + self.r
        self.max_correct = max_correct

    def _syndrome_of(self, err: np.ndarray) -> int:
        # H = [P^T | I_r]; syndrome = err @ H^T
        s = ((err[: self.k] @ self.p) % 2) ^ err[self.k :]
        return int(np.dot(s, 1 << np.arange(self.r)))

    @functools.cached_property
    def _syndrome_table(self) -> np.ndarray:
        """[2**r, n] uint8: the lowest-weight error pattern (up to
        ``max_correct``) of each syndrome, first in combination order."""
        table = np.zeros((1 << self.r, self.n), dtype=np.uint8)
        filled = np.zeros(1 << self.r, dtype=bool)
        filled[0] = True
        for w in range(1, self.max_correct + 1):
            for combo in itertools.combinations(range(self.n), w):
                err = np.zeros(self.n, dtype=np.uint8)
                err[list(combo)] = 1
                s = self._syndrome_of(err)
                if not filled[s]:
                    table[s] = err
                    filled[s] = True
        return table

    def encode_host(self, bits: np.ndarray) -> np.ndarray:
        """[nblocks, k] -> [nblocks, n] (numpy oracle)."""
        parity = (bits @ self.p) % 2
        return np.concatenate([bits, parity], axis=-1).astype(np.uint8)

    def decode_host(self, bits: np.ndarray) -> np.ndarray:
        """[nblocks, n] -> corrected data [nblocks, k] by the syndrome table
        (numpy oracle)."""
        data, par = bits[:, : self.k], bits[:, self.k :]
        s = ((data @ self.p) % 2) ^ par
        err = self._syndrome_table[s @ (1 << np.arange(self.r))]
        return (bits ^ err)[:, : self.k].astype(np.uint8)

    def _p(self, device: torch.device) -> torch.Tensor:
        return device_const(
            ("block_p", self.name), lambda: self.p.astype(np.float32), device
        )

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """bits [..., nblocks*k] int8 -> [..., nblocks*n] int8."""
        shape = bits.shape[:-1] + (bits.shape[-1] // self.k, self.k)
        m = bits.reshape(shape).to(torch.float32)
        parity = torch.remainder(m @ self._p(bits.device), 2.0)
        out = torch.cat([m, parity], dim=-1).to(torch.int8)
        return out.reshape(bits.shape[:-1] + (shape[-2] * self.n,))

    def decode(self, bits: torch.Tensor) -> torch.Tensor:
        """bits [..., nblocks*n] int8 -> corrected data [..., nblocks*k] int8."""
        dev = bits.device
        weights = device_const(
            ("syndrome_weights", self.r), lambda: (1 << np.arange(self.r)).astype(np.int32), dev)
        shape = bits.shape[:-1] + (bits.shape[-1] // self.n, self.n)
        c = bits.reshape(shape).to(torch.int32)
        data, par = c[..., : self.k], c[..., self.k :]
        syn = torch.remainder(data.to(torch.float32) @ self._p(dev), 2.0).to(torch.int32) ^ par
        sidx = torch.sum(syn * weights, dim=-1).to(torch.int32)  # packed syndrome
        if self.name == "golay2412":
            e_u = _decode_golay_packed(sidx)
            shifts = torch.arange(self.k, dtype=torch.int32, device=dev)
            err = (e_u[..., None] >> shifts) & 1
        else:
            # the syndrome of a single error in data bit j is row j of P: a
            # correction fires iff sidx matches one of them. A parity-bit
            # error (sidx = 1 << j) matches no data row: data unchanged.
            rows = device_const(
                ("block_rows", self.name),
                lambda: (self.p.astype(np.int64) @ (1 << np.arange(self.r))).astype(np.int32),
                dev,
            )
            err = (sidx[..., None] == rows).to(torch.int32)
        corrected = (data ^ err).to(torch.int8)
        return corrected.reshape(bits.shape[:-1] + (shape[-2] * self.k,))


@functools.lru_cache(maxsize=None)
def hamming74() -> LinearBlockCode:
    return LinearBlockCode("hamming74", _hamming_parity_matrix(4, 3))


@functools.lru_cache(maxsize=None)
def hamming128() -> LinearBlockCode:
    """Hamming(12,8): Hamming(15,11) shortened to 8 data bits."""
    return LinearBlockCode("hamming128", _hamming_parity_matrix(8, 4))


def _secded(k: int, r: int, name: str) -> LinearBlockCode:
    """Shortened Hamming + overall parity: (k + r + 1, k) SEC-DED code. The
    overall parity makes the codeword weight even; as a column of P it folds
    in each data bit's own Hamming-parity contributions."""
    p_ham = _hamming_parity_matrix(k, r)
    col = (1 + p_ham.sum(axis=1)) % 2
    return LinearBlockCode(name, np.concatenate([p_ham, col[:, None]], axis=1))


@functools.lru_cache(maxsize=None)
def secded2216() -> LinearBlockCode:
    return _secded(16, 5, "secded2216")


@functools.lru_cache(maxsize=None)
def secded3932() -> LinearBlockCode:
    return _secded(32, 6, "secded3932")


@functools.lru_cache(maxsize=None)
def secded7264() -> LinearBlockCode:
    return _secded(64, 7, "secded7264")


@functools.lru_cache(maxsize=None)
def golay2412() -> LinearBlockCode:
    return LinearBlockCode("golay2412", _golay_b_matrix(), max_correct=3)
