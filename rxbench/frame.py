"""The flexframe format and the stream layout, frozen for the benchmark.

A configuration file (``configs/<name>.json``) names one of the payload
chains below; this module turns it into the frame geometry that the
transmitter, the reference receiver and the frame accounting share. Only the
chains the benchmark's configurations use are here: QPSK payloads, inner code
none or V27 (K=7, rate 1/2), outer code none or Golay(24,12), CRC-24.

Frame: [64 preamble symbols | 180 header symbols | payload symbols], RRC
interpolated at 2 samples a symbol with a 29-tap pulse ('full'
convolution), so a frame spans 2 * symbols + 28 samples.

Stream layout (``long_stream``'s): per channel a frame every
``period = 37 + f + int(0.8 f)`` samples after a lead-in of
``37 + b * period // batch`` samples on channel b, every frame with its own
payload. The stream is a circle of ``pool_chunks`` chunks: frame j of
channel b starts at ``lead_b + j * period`` for ``j < circle // period``,
taken modulo the circle, so a frame may run across the wrap and every chunk
of every cycle holds known frames.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

PREAMBLE_SYMS = 64
HEADER_SYMS = 180
HEADER_USER_BYTES = 14
HEADER_BYTES = 22  # 14 user + payload_len u16 + mod + inner + outer + CRC-24
HEADER_BITS = 8 * HEADER_BYTES  # 176
HEADER_BITS_PADDED = 180  # a whole number of Golay blocks
K_SAMP = 2
PULSE_LEN = 29
PULSE_TAIL = PULSE_LEN - 1
CRC_BYTES = 3
INTERLEAVE_DEPTH = 16
TEMPLATE_LEN = K_SAMP * PREAMBLE_SYMS  # 128
V27_TAIL = 6
LEAD_IN = 37

MODULATIONS = {1: "qpsk"}
INNER_CODES = {0: "none", 1: "v27"}
OUTER_CODES = {0: "none", 1: "golay2412"}
PRECISIONS = ("float32",)

CONFIG_DIR = Path(__file__).resolve().parent / "configs"


@dataclasses.dataclass(frozen=True)
class Config:
    """One configuration file: the payload chain, the channel and what the
    receiver is provisioned with."""

    name: str
    modulation: int
    inner_code: int
    outer_code: int
    payload_len: int
    snr_db: float
    cfo_max: float  # |carrier offset| drawn per channel, rad/sample
    threshold: float  # the receiver's detection threshold
    precision: str

    def __post_init__(self):
        if self.modulation not in MODULATIONS:
            raise ValueError(f"{self.name}: modulation {self.modulation} is not in {MODULATIONS}")
        if self.inner_code not in INNER_CODES:
            raise ValueError(f"{self.name}: inner code {self.inner_code} is not in {INNER_CODES}")
        if self.outer_code not in OUTER_CODES:
            raise ValueError(f"{self.name}: outer code {self.outer_code} is not in {OUTER_CODES}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"{self.name}: precision {self.precision} is not in {PRECISIONS}")

    @property
    def msg_bytes(self) -> int:
        return self.payload_len + CRC_BYTES

    @property
    def outer_bits(self) -> int:
        bits = 8 * self.msg_bytes
        return bits if self.outer_code == 0 else -(-bits // 12) * 24

    @property
    def inner_bits(self) -> int:
        return self.outer_bits if self.inner_code == 0 else 2 * (self.outer_bits + V27_TAIL)

    @property
    def payload_syms(self) -> int:
        return -(-self.inner_bits // 2)

    @property
    def frame_syms(self) -> int:
        return PREAMBLE_SYMS + HEADER_SYMS + self.payload_syms

    @property
    def frame_samples(self) -> int:
        return K_SAMP * self.frame_syms + PULSE_TAIL

    @property
    def overlap(self) -> int:
        """Samples a streaming window carries from the chunk before."""
        return self.frame_samples - 1

    @property
    def period(self) -> int:
        f = self.frame_samples
        return LEAD_IN + f + int(0.8 * f)


def load_config(name: str) -> Config:
    """``configs/<name>.json`` as a ``Config``."""
    d = json.loads((CONFIG_DIR / f"{name}.json").read_text())
    if d.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {d.get('name')!r}")
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: d[k] for k in fields})


def interleave_perm(n: int, depth: int = INTERLEAVE_DEPTH) -> np.ndarray:
    """Row-write, column-read bit interleaver of length n: out[i] = in[perm[i]]."""
    cols = -(-n // depth)
    order = np.arange(depth * cols).reshape(depth, cols).T.reshape(-1)
    return order[order < n].astype(np.int64)


def slots_for(cfg: Config, span: int) -> int:
    """Slots a receiver window of ``span`` new samples needs: every frame
    that starts in ``span + frame_samples - 1`` samples, and two to spare."""
    return (span + cfg.frame_samples - 1) // cfg.period + 2


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where every frame of the circle starts: ``starts[b, j]`` is frame j of
    channel b, unwrapped (it may exceed the circle; modulo the circle it is
    the position in the stream of every cycle)."""

    batch: int
    circle: int
    starts: np.ndarray  # [batch, n] int64

    @property
    def frames_per_channel(self) -> int:
        return self.starts.shape[1]


def circle_layout(cfg: Config, batch: int, circle: int) -> Layout:
    p = cfg.period
    n = circle // p
    if n < 1:
        raise ValueError(f"a circle of {circle} samples holds no frame period of {p}")
    lead = LEAD_IN + (np.arange(batch, dtype=np.int64) * p) // batch
    return Layout(batch, circle, lead[:, None] + p * np.arange(n, dtype=np.int64)[None, :])

