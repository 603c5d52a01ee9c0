"""Device selection and per-device constant tables.

Entry points take ``device=None``, which means the GPU: no code path carries
on on the CPU when it finds no card. Callers that want the CPU (the tests)
say so with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: liquiddsp_tpu_torch runs on the GPU unless "
                'the caller passes device="cpu"'
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


_CONSTS: dict[tuple, torch.Tensor] = {}


def device_const(
    key: tuple, build: Callable[[], np.ndarray], device: torch.device
) -> torch.Tensor:
    """The numpy table ``build()`` as a tensor on ``device``, in the table's
    own dtype, made once per (key, device)."""
    k = (key, str(device))
    t = _CONSTS.get(k)
    if t is None:
        t = torch.from_numpy(np.array(build())).to(device)
        _CONSTS[k] = t
    return t
