"""Typed configuration space for the adaptive flexframe PHY.

Mirrors the reference's integer parameter spaces exactly:

- modulation index 0-10  -> {PSK2, PSK4, PSK8, PSK16, DPSK2, DPSK4, DPSK8,
  ASK4, QAM16, QAM32, QAM64}            (reference lib/flex_tx_impl.cc:76-116)
- inner FEC index 0-6    -> {NONE, CONV_V27, CONV_V27P23, CONV_V27P45,
  CONV_V27P56, CONV_V27P67, CONV_V27P78} (reference lib/flex_tx_impl.cc:119-147)
- outer FEC index 0-7    -> {NONE, GOLAY2412, RS_M8, HAMMING74, HAMMING128,
  SECDED2216, SECDED3932, SECDED7264}    (reference lib/flex_tx_impl.cc:150-181)

config_id = modulation*7*8 + inner*8 + outer + 1, 1..616
(reference python/cognitive_engine.py:87).

Note on rates: the reference's cognitive engine assumes inner code rates
(1, 1/2, 2/3, 3/4, 4/5, 5/6, 6/7) (python/cognitive_engine.py:695-715) even
though the liquid enums it selects are V27P{23,45,56,67,78} whose true rates
are (2/3, 4/5, 5/6, 6/7, 7/8). We reproduce the engine's reward table
verbatim (``ce_inner_rate``/``ce_outer_rate``) for adaptation parity, and
separately expose the *actual* rates of the codes this framework implements
(``true_inner_rate``/``true_outer_rate``) for frame-geometry computation.
"""

from __future__ import annotations

import dataclasses
import enum
from fractions import Fraction

NUM_MODULATIONS = 11
NUM_INNER_CODES = 7
NUM_OUTER_CODES = 8
NUM_CONFIGS = NUM_MODULATIONS * NUM_INNER_CODES * NUM_OUTER_CODES  # 616


class Modulation(enum.IntEnum):
    """Modulation index as used by the reference (lib/flex_tx_impl.cc:76-116)."""

    PSK2 = 0
    PSK4 = 1
    PSK8 = 2
    PSK16 = 3
    DPSK2 = 4
    DPSK4 = 5
    DPSK8 = 6
    ASK4 = 7
    QAM16 = 8
    QAM32 = 9
    QAM64 = 10


class InnerCode(enum.IntEnum):
    """Inner FEC index (lib/flex_tx_impl.cc:119-147). V27* are K=7 conv codes."""

    NONE = 0
    V27 = 1  # rate 1/2, K=7
    V27P23 = 2  # punctured 2/3
    V27P45 = 3  # punctured 4/5
    V27P56 = 4  # punctured 5/6
    V27P67 = 5  # punctured 6/7
    V27P78 = 6  # punctured 7/8


class OuterCode(enum.IntEnum):
    """Outer FEC index (lib/flex_tx_impl.cc:150-181)."""

    NONE = 0
    GOLAY2412 = 1
    RS_M8 = 2  # Reed-Solomon, 8-bit symbols (255,223), shortened
    HAMMING74 = 3
    HAMMING128 = 4
    SECDED2216 = 5
    SECDED3932 = 6
    SECDED7264 = 7


# bits per symbol for each modulation index
MOD_BPS = (1, 2, 3, 4, 1, 2, 3, 2, 4, 5, 6)
# constellation size per modulation index (python/cognitive_engine.py:661-693)
MOD_CONSTELLATION_N = (2, 4, 8, 16, 2, 4, 8, 4, 16, 32, 64)
MOD_TYPE_NAME = (
    "PSK", "PSK", "PSK", "PSK", "DPSK", "DPSK", "DPSK", "ASK", "QAM", "QAM", "QAM",
)

# --- rates as assumed by the reference cognitive engine (reward definition) ---
# python/cognitive_engine.py:695-715
CE_INNER_RATE = (
    Fraction(1),
    Fraction(1, 2),
    Fraction(2, 3),
    Fraction(3, 4),
    Fraction(4, 5),
    Fraction(5, 6),
    Fraction(6, 7),
)
# python/cognitive_engine.py:717-740
CE_OUTER_RATE = (
    Fraction(1),
    Fraction(12, 24),
    Fraction(4, 8),
    Fraction(4, 7),
    Fraction(8, 12),
    Fraction(16, 22),
    Fraction(32, 39),
    Fraction(64, 72),
)
INNER_TYPE_NAME = ("None", "Conv", "Conv", "Conv", "Conv", "Conv", "Conv")
OUTER_TYPE_NAME = (
    "None", "Golay", "Reed-Solomon", "Hamming", "Hamming", "SECDED", "SECDED", "SECDED",
)

# --- true rates of the codes implemented by this framework ---
TRUE_INNER_RATE = (
    Fraction(1),
    Fraction(1, 2),
    Fraction(2, 3),
    Fraction(4, 5),
    Fraction(5, 6),
    Fraction(6, 7),
    Fraction(7, 8),
)
TRUE_OUTER_RATE = (
    Fraction(1),
    Fraction(12, 24),
    Fraction(223, 255),  # per full RS block; shortened blocks differ
    Fraction(4, 7),
    Fraction(8, 12),
    Fraction(16, 22),
    Fraction(32, 39),
    Fraction(64, 72),
)


def config_id(modulation: int, inner_code: int, outer_code: int) -> int:
    """1-based config id (python/cognitive_engine.py:87)."""
    return modulation * NUM_INNER_CODES * NUM_OUTER_CODES + inner_code * NUM_OUTER_CODES + outer_code + 1


def config_from_id(cid: int) -> tuple[int, int, int]:
    i = cid - 1
    return (
        i // (NUM_INNER_CODES * NUM_OUTER_CODES),
        (i // NUM_OUTER_CODES) % NUM_INNER_CODES,
        i % NUM_OUTER_CODES,
    )


@dataclasses.dataclass(frozen=True)
class ConfigurationMap:
    """Pure function of (modulation, inner, outer) -> rates/type names.

    Parity with the reference's ConfigurationMap
    (python/cognitive_engine.py:646-740): same constellation sizes, type names
    and (engine-assumed) coding rates; the goodput upper bound is
    log2(M) * outer_rate * inner_rate.
    """

    modulation: int
    inner_code: int
    outer_code: int
    conf_id: int = 0

    def __post_init__(self):
        if not (0 <= self.modulation < NUM_MODULATIONS):
            raise ValueError(f"modulation {self.modulation} out of range")
        if not (0 <= self.inner_code < NUM_INNER_CODES):
            raise ValueError(f"inner_code {self.inner_code} out of range")
        if not (0 <= self.outer_code < NUM_OUTER_CODES):
            raise ValueError(f"outer_code {self.outer_code} out of range")

    @property
    def constellationN(self) -> int:
        return MOD_CONSTELLATION_N[self.modulation]

    @property
    def modulationtype(self) -> str:
        return MOD_TYPE_NAME[self.modulation]

    @property
    def innercodingrate(self) -> float:
        return float(CE_INNER_RATE[self.inner_code])

    @property
    def innercodingtype(self) -> str:
        return INNER_TYPE_NAME[self.inner_code]

    @property
    def outercodingrate(self) -> float:
        return float(CE_OUTER_RATE[self.outer_code])

    @property
    def outercodingtype(self) -> str:
        return OUTER_TYPE_NAME[self.outer_code]

    @property
    def goodput_upper_bound(self) -> float:
        """log2(M) * r_outer * r_inner (python/cognitive_engine.py:89)."""
        import math

        return math.log2(self.constellationN) * self.outercodingrate * self.innercodingrate


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static per-frame PHY configuration.

    The (modulation, inner, outer) triple is the reference's runtime-mutable
    ``flexframegenprops`` analog (lib/flex_tx_impl.cc:183-189); payload_len is
    per-packet in the reference but fixed per TX/RX call here (all shapes
    follow from the config).
    """

    modulation: int = int(Modulation.PSK4)
    inner_code: int = int(InnerCode.NONE)
    outer_code: int = int(OuterCode.NONE)
    payload_len: int = 64  # bytes

    @property
    def bps(self) -> int:
        return MOD_BPS[self.modulation]

    @property
    def conf_id(self) -> int:
        return config_id(self.modulation, self.inner_code, self.outer_code)

    def map(self) -> ConfigurationMap:
        return ConfigurationMap(self.modulation, self.inner_code, self.outer_code, self.conf_id)
