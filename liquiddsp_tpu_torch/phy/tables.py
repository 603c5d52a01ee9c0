"""The constant tables of the PHY as tensors on one device.

The PHY has no learned weights; its "parameters" are constant tables built
with numpy. ``numpy_tables`` builds them with this package's own table functions,
``tables_from_numpy`` turns such a dict into ``PhyTables`` on a device, and
``phy_tables`` is the cached default that the entry points use. A test can
build the dict from another implementation's table functions and hand it in.

Tables that belong to one op (CRC matrices, the Golay parity matrix, the
trellis signs, the constellations) stay with that op and are cached per
device by ``core.device.device_const``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PhyTables:
    """Config-independent tables, plus the interleaver and constellation of
    one FrameConfig (``None`` when built without a config)."""

    templates: torch.Tensor  # [5, 128] complex64 — CFO-shifted preamble templates
    delayed_templates: torch.Tensor  # [25, 128] complex64 — fine_cfo references
    timing_bank30: torch.Tensor  # [33, 30] float32 — matched-filter rows by tau
    timing_bank65: torch.Tensor  # [65, 32] float32 — SFO-path rows by sampling instant
    preamble: torch.Tensor  # [64] complex64 — preamble symbols
    rrc_taps: torch.Tensor  # [29] float32 — TX pulse
    constellation: torch.Tensor | None = None  # [2**bps] complex64
    interleave_perm: torch.Tensor | None = None  # [inner_bits] int64
    interleave_inv: torch.Tensor | None = None  # [inner_bits] int64


def numpy_tables(cfg: FrameConfig | None = None) -> dict[str, np.ndarray]:
    """Every ``PhyTables`` field as a numpy array, from this package's table functions."""
    from liquiddsp_tpu_torch.ops import modem, msequence, rrc
    from liquiddsp_tpu_torch.phy import detector, framesync
    from liquiddsp_tpu_torch.phy import frame_spec as fs

    d = {
        "templates": detector.templates_time(),
        "delayed_templates": detector._delayed_templates(),
        "timing_bank30": framesync._timing_bank30(),
        "timing_bank65": framesync._timing_bank65(),
        "preamble": msequence.preamble_symbols(),
        "rrc_taps": rrc.matched_taps(),
    }
    if cfg is not None:
        n = fs.FrameSpec(cfg).inner_bits
        d["constellation"] = modem.constellation(cfg.modulation)
        d["interleave_perm"] = fs.interleave_perm(n)
        d["interleave_inv"] = fs.interleave_inv(n)
    return d


_DTYPES = {
    "templates": np.complex64, "delayed_templates": np.complex64,
    "timing_bank30": np.float32, "timing_bank65": np.float32, "preamble": np.complex64,
    "rrc_taps": np.float32, "constellation": np.complex64,
    "interleave_perm": np.int64, "interleave_inv": np.int64,
}


def tables_from_numpy(
    d: dict[str, np.ndarray], device: torch.device | str | None = None
) -> PhyTables:
    """A dict of numpy tables (``numpy_tables`` layout) -> ``PhyTables``."""
    dev = resolve_device(device)
    return PhyTables(**{
        k: torch.from_numpy(np.ascontiguousarray(np.asarray(v).astype(_DTYPES[k]))).to(dev)
        for k, v in d.items()
    })


@functools.lru_cache(maxsize=None)
def _cached(cfg: FrameConfig | None, device: torch.device) -> PhyTables:
    return tables_from_numpy(numpy_tables(cfg), device)


def phy_tables(
    cfg: FrameConfig | None = None, device: torch.device | str | None = None
) -> PhyTables:
    """This package's own tables for ``cfg`` on ``device``, built once."""
    return _cached(cfg, resolve_device(device))
