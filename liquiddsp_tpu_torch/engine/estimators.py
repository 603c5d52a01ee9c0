"""Statistical estimators for the cognitive engine's arm statistics.

Counterpart of ``liquiddsp_tpu/engine/estimators.py`` (host numpy/scipy).

Parity targets (python/cognitive_engine.py):
- ``throughput_ci``: Student-t confidence interval on mean throughput,
  clipped to [0, maxp + 1e-7]                        (reference py:555-567)
- ``psr_ci``: Bayesian beta-posterior interval on packet success rate
  with a z-quantile on the posterior std              (reference py:569-581)
- ``gittins_index_normal_unit_var``: the 29x8 lookup table of Gittins
  indices for the normal-unknown-mean bandit, linearly interpolated over
  trial count and scaled by 1/(N*sqrt(1-gamma))       (reference py:583-643)

All are vectorized over the 616-arm axis (the reference loops SQL rows).
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.stats import norm, t as t_dist

CONFIDENCE = 0.9  # reference py:30


@functools.lru_cache(maxsize=8)
def _t_ppf_table(c: float) -> np.ndarray:
    """t-quantiles for integer dof 1..1024 at confidence level ``c``.

    scipy's scalar ``t.ppf`` dominated the per-packet engine cost; dof here is always the integer n-1 of
    an arm's observation count, so a table lookup is bit-identical. Beyond
    dof 1024 the t quantile matches the normal quantile to ~1e-4 — the
    table's last row is used."""
    return t_dist.ppf(c, np.arange(1, 1025))


@functools.lru_cache(maxsize=8)
def _norm_ppf(c: float) -> float:
    return float(norm.ppf(c))


def throughput_ci(
    mean: np.ndarray, variance: np.ndarray, maxp: np.ndarray, n: np.ndarray,
    confidence: float = CONFIDENCE,
) -> tuple[np.ndarray, np.ndarray]:
    """Student-t CI on mean throughput; vectorized (reference CI(), py:555-567)."""
    c = 1.0 - (1.0 - confidence) / 2.0
    n = np.asarray(n, dtype=np.float64)
    dof = np.maximum(n - 1, 1)
    table = _t_ppf_table(c)
    coeff = table[np.clip(dof.astype(np.int64), 1, len(table)) - 1]
    std = np.sqrt(np.maximum(variance, 0.0))
    half = coeff * std / np.sqrt(np.maximum(n, 1))
    lo = np.maximum(mean - half, 0.0)
    hi = np.minimum(mean + half + 1e-7, maxp + 1e-7)
    return lo, hi


def psr_ci(
    success: np.ndarray, unsuccess: np.ndarray, confidence: float = CONFIDENCE
) -> tuple[np.ndarray, np.ndarray]:
    """Beta-posterior PSR interval; vectorized (reference PSR_CI(), py:569-581)."""
    a = np.asarray(success, dtype=np.float64) + 1.0
    b = np.asarray(unsuccess, dtype=np.float64) + 1.0
    m = a / (a + b)
    v = a * b / ((a + b) ** 2 * (a + b + 1.0))
    z = _norm_ppf(confidence)
    std = np.sqrt(v)
    lo = np.maximum(m - z * std, 0.0)
    hi = np.minimum(m + z * std + 1e-4, 1.0)
    return lo, hi


# Gittins index table for the normal bandit with unknown mean, unit variance
# (reference py:583-615). Rows: observation counts; columns: discount factors.
_GITTINS_DISCOUNTS = np.array([0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 0.995])
_GITTINS_COUNTS = np.array(
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 20, 30, 40, 50, 60, 70, 80, 90,
     100, 200, 300, 400, 500, 600, 700, 800, 900, 1000, 9999999]
)
_GITTINS_V = np.array([
    [0.14542, 0.17451, 0.20218, 0.22582, 0.23609, 0.22263, 0.15758, 0.12852],
    [0.17209, 0.20815, 0.24359, 0.27584, 0.29485, 0.28366, 0.20830, 0.17192],
    [0.18522, 0.22513, 0.26515, 0.30297, 0.32876, 0.32072, 0.24184, 0.20137],
    [0.19317, 0.23560, 0.27874, 0.32059, 0.35179, 0.34687, 0.26709, 0.22398],
    [0.19855, 0.24277, 0.28820, 0.33314, 0.36879, 0.36678, 0.28736, 0.24242],
    [0.20244, 0.24801, 0.29521, 0.34261, 0.38200, 0.38267, 0.30429, 0.25803],
    [0.20539, 0.25202, 0.30063, 0.35005, 0.39265, 0.39577, 0.31881, 0.27158],
    [0.20771, 0.25520, 0.30496, 0.35607, 0.40146, 0.40682, 0.33149, 0.28356],
    [0.20959, 0.25777, 0.30851, 0.36105, 0.40889, 0.41631, 0.34275, 0.29428],
    [0.21113, 0.25991, 0.31147, 0.36525, 0.41526, 0.42458, 0.35285, 0.30400],
    [0.21867, 0.27048, 0.32642, 0.38715, 0.45047, 0.47295, 0.41888, 0.36986],
    [0.22142, 0.27443, 0.33215, 0.39593, 0.46577, 0.49583, 0.45587, 0.40886],
    [0.22286, 0.27650, 0.33520, 0.40070, 0.47448, 0.50953, 0.48072, 0.43613],
    [0.22374, 0.27778, 0.33709, 0.40370, 0.48013, 0.51876, 0.49898, 0.45679],
    [0.22433, 0.27864, 0.33838, 0.40577, 0.48411, 0.52543, 0.51313, 0.47324],
    [0.22476, 0.27927, 0.33932, 0.40728, 0.48707, 0.53050, 0.52451, 0.48677],
    [0.22508, 0.27974, 0.34003, 0.40843, 0.48935, 0.53449, 0.53391, 0.49817],
    [0.22534, 0.28011, 0.34059, 0.40934, 0.49117, 0.53771, 0.54184, 0.50796],
    [0.22554, 0.28041, 0.34104, 0.41008, 0.49266, 0.54037, 0.54864, 0.51648],
    [0.22646, 0.28177, 0.34311, 0.41348, 0.49970, 0.55344, 0.58626, 0.56637],
    [0.22678, 0.28223, 0.34381, 0.41466, 0.50219, 0.55829, 0.60270, 0.59006],
    [0.22693, 0.28246, 0.34416, 0.41525, 0.50347, 0.56084, 0.61220, 0.60436],
    [0.22703, 0.28260, 0.34438, 0.41561, 0.50425, 0.56242, 0.61844, 0.61410],
    [0.22709, 0.28270, 0.34452, 0.41585, 0.50478, 0.56351, 0.62290, 0.62123],
    [0.22714, 0.28276, 0.34462, 0.41602, 0.50516, 0.56431, 0.62629, 0.62674],
    [0.22717, 0.28281, 0.34470, 0.41615, 0.50545, 0.56493, 0.62896, 0.63116],
    [0.22720, 0.28285, 0.34476, 0.41625, 0.50568, 0.56543, 0.63121, 0.63481],
    [0.22722, 0.28288, 0.34480, 0.41633, 0.50587, 0.56583, 0.63308, 0.63789],
    [0.22741, 0.28316, 0.34524, 0.41714, 0.5092, 0.583, 0.65, 0.65],
])


def gittins_index_normal_unit_var(n_obs, discount: float):
    """Interpolated Gittins index scaled by 1/(N*sqrt(1-gamma)).

    Vectorized over n_obs (reference GittinsIndexNormalUnitVar, py:583-643).
    """
    col = int(np.argmin(np.abs(_GITTINS_DISCOUNTS - discount)))
    n = np.atleast_1d(np.asarray(n_obs, dtype=np.float64))
    v = np.interp(n, _GITTINS_COUNTS, _GITTINS_V[:, col])
    idx = v / (n * np.sqrt(1.0 - discount))
    return idx if np.ndim(n_obs) else float(idx[0])
