"""Knowledge indicators: learning-progress metrics over the arm space.

Counterpart of ``liquiddsp_tpu/engine/knowledge.py`` (host numpy).

Vectorized re-implementation of the reference KnowledgeIndicator
(python/cognitive_engine.py:1141-1194), whose per-packet loop runs 616
SELECTs — a flagged host hot loop (SURVEY.md section 3 "hot loops"). Here it
is four numpy reductions:

- LBI: fraction of arms provably suboptimal, (Nk - Ne)/(Nk - 1) where Ne
  counts arms whose UB exceeds the best mean
- RBI: best mean / global upper bound
- CCI: 1 - residual CI mass above the best mean
- CI:  1 - entropy/initial entropy, entropy = sum log(BW * CI width) over
  arms with UB > best mean

In contextual mode the chosen indicator drives the global exploration rate
c_epsilon = 1 - indicator (reference py:1179-1191, consumed at py:117-120).
"""

from __future__ import annotations

import numpy as np

from liquiddsp_tpu_torch.engine.store import ArmStore

BW = 100.0  # reference py:35


class KnowledgeIndicator:
    def __init__(self, store: ArmStore):
        self.store = store
        self.c_epsilon = 1.0  # reference module global c_epsilon (py:36)

    def compute(self, num_trial: int, contextual_type: str = "none") -> dict:
        s = self.store
        nk = len(s.alg_mean)
        mu_best = float(np.max(s.mean_throughput))
        upper_max = float(np.max(s.ub_throughput))
        lower, upper = s.lb_throughput, s.ub_throughput
        width = upper - lower
        above = upper > mu_best
        ne = int(np.sum(above))
        cci_nom = float(np.sum(np.where(above, upper - mu_best, 0.0)))
        cci_den = float(np.sum(width))
        with np.errstate(divide="ignore"):
            ent_terms = np.where(above, np.log(np.maximum(BW * width, 1e-300)), 0.0)
        entropy = float(np.sum(ent_terms))

        lbi = (nk - ne) / (nk - 1)
        rbi = mu_best / upper_max if upper_max > 0 else 0.0
        cci = 1.0 - (cci_nom / cci_den if cci_den > 0 else 0.0)
        ci = 1.0 - (entropy / s.initial_entropy if s.initial_entropy else 0.0)

        if contextual_type == "context_lbi":
            self.c_epsilon = 1.0 - lbi
        elif contextual_type == "context_rbi":
            self.c_epsilon = 1.0 - rbi
        elif contextual_type == "context_cci":
            self.c_epsilon = 1.0 - cci
        elif contextual_type == "context_ci":
            self.c_epsilon = 1.0 - ci

        s.ki_log.append((num_trial, lbi, rbi, cci, ci))
        return {"LBI": lbi, "RBI": rbi, "CCI": cci, "CI": ci, "c_epsilon": self.c_epsilon}
