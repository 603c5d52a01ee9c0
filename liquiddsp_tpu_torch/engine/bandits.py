"""Bandit decision algorithms over the 616-arm configuration space.

Counterpart of ``liquiddsp_tpu/engine/bandits.py`` (host numpy).

Vectorized re-implementations of the reference CognitiveEngine
(python/cognitive_engine.py:743-1138): epsilon_greedy (py:754-858),
annealing_epsilon_greedy (py:860-937), gittins (py:939-979), RoTA
(py:981-1138), plus the SNR-switched "meta" mode the block layer implements
at py:129-139. The sqlite row scans become numpy argmax/mask operations.

Each algorithm returns the chosen ConfigurationMap (the reference returns a
(NextConf1, NextConf2) pair whose elements are identical in every code path;
we keep the pair for API parity). In delayed-feedback mode the algorithms
pre-write substituted rewards exactly as the reference does
(py:842-858, 922-937, 964-979, 1123-1138).
"""

from __future__ import annotations

import random

import numpy as np

from liquiddsp_tpu_torch.core.config import ConfigurationMap, config_from_id
from liquiddsp_tpu_torch.engine.store import ArmStore

WINDOW_SIZE = 100  # reference py:32


def _conf(config_id: int) -> ConfigurationMap:
    m, i, o = config_from_id(config_id)
    return ConfigurationMap(m, i, o, config_id)


class CognitiveEngine:
    """One decision engine bound to an ArmStore (single state owner)."""

    def __init__(self, store: ArmStore, rng: random.Random | None = None):
        self.store = store
        self.rng = rng or random.Random()

    # -- helpers ------------------------------------------------------------

    def _random_choice(self, ids: np.ndarray) -> int:
        return int(ids[self.rng.randrange(len(ids))])

    def _post_delay(self, ce_type: str, config_id: int, num_trial: int,
                    delayed_feedback: str, delayed_strategy: str):
        """Delayed-mode substituted-reward pre-write (py:842-858 etc.)."""
        if delayed_feedback != "delay":
            self.store.write_tx_result(config_id, num_trial, delayed_feedback, delayed_strategy)
            return
        a = config_id - 1
        s = self.store
        if delayed_strategy == "mean":
            if s.alg_trials[a] == 0:
                sub = (s.alg_lower[a] + s.alg_upper[a]) / 2.0
            else:
                sub = s.alg_mean[a]
        elif delayed_strategy == "lower":
            sub = s.alg_lower[a]
        else:
            sub = s.alg_upper[a]
        s.write_tx_result(config_id, num_trial, delayed_feedback, delayed_strategy)
        s.write_configuration(ce_type, config_id, 1.0, 1.0, sub, 0.0)

    # -- algorithms ---------------------------------------------------------

    def epsilon_greedy(self, num_trial: int, epsilon: float, delayed_feedback: str,
                       delayed_strategy: str, channel: str):
        """py:754-858: UCB-pruned eligibility, explore w.p. epsilon among
        eligible arms, else exploit argmax-mean with random tie-break."""
        s = self.store
        mu_best = float(np.max(s.alg_mean))
        s.eligibility = (s.alg_upper >= mu_best).astype(np.int64)
        if self.rng.random() > epsilon:
            ids = np.nonzero(s.alg_mean == mu_best)[0] + 1
        else:
            ids = np.nonzero(s.eligibility == 1)[0] + 1
        chosen = self._random_choice(ids)
        self._post_delay("epsilon_greedy", chosen, num_trial, delayed_feedback, delayed_strategy)
        c = _conf(chosen)
        return c, c

    def annealing_epsilon_greedy(self, num_trial: int, epsilon: float, delayed_feedback: str,
                                 delayed_strategy: str, channel: str):
        """py:860-937: identical structure; the caller anneals epsilon
        (-0.001/packet, floor 0.05 — py:123-126)."""
        return self.epsilon_greedy(num_trial, epsilon, delayed_feedback, delayed_strategy, channel)

    def gittins(self, num_trial: int, discount: float, delayed_feedback: str,
                delayed_strategy: str, channel: str):
        """py:939-979: play argmax Gittins index, random tie-break."""
        s = self.store
        hi = float(np.max(s.gittins_index))
        ids = np.nonzero(s.gittins_index == hi)[0] + 1
        chosen = self._random_choice(ids)
        # delayed substitution uses CONFIG-table stats in the reference
        # (py:964-975): mean of sums, or (LB+UB)/2 when unvisited
        if delayed_feedback == "delay":
            a = chosen - 1
            if delayed_strategy == "mean":
                if s.trial_n[a] > 0:
                    sub = s.throughput_sum[a] / s.trial_n[a]
                else:
                    sub = (s.lb_throughput[a] + s.ub_throughput[a]) / 2.0
            elif delayed_strategy == "lower":
                sub = s.lb_throughput[a]
            else:
                sub = s.ub_throughput[a]
            s.write_tx_result(chosen, num_trial, delayed_feedback, delayed_strategy)
            s.write_configuration("gittins", chosen, 1.0, 1.0, sub, 0.0)
        else:
            s.write_tx_result(chosen, num_trial, delayed_feedback, delayed_strategy)
        c = _conf(chosen)
        return c, c

    def rota(self, num_trial: int, throughput_threshold: float, psr_threshold: float,
             delayed_feedback: str, delayed_strategy: str, channel: str):
        """py:981-1138 "Rules of Thumb Adaptation": three-way eligibility
        classification against the throughput threshold and the current best,
        infant-stage random exploration, windowed-throughput-gated Gittins
        training, else greedy fallback to the best qualified arm."""
        s = self.store
        window = max(num_trial - WINDOW_SIZE, 0)
        mu_best = float(np.max(s.alg_mean))
        upper, lower = s.alg_upper, s.alg_lower
        elig = np.ones(len(upper), dtype=np.int64)
        elig[(upper < throughput_threshold) | (upper < mu_best)] = 0
        elig[(elig != 0) & (lower >= throughput_threshold)] = 2
        s.eligibility = elig
        qualified = np.nonzero(elig == 2)[0]
        trainees = np.nonzero(elig == 1)[0]

        if len(qualified) == 0:
            if len(trainees) > 0:
                chosen = self._random_choice(trainees + 1)  # infant stage
            else:
                chosen = int(np.argmax(s.alg_mean)) + 1  # nothing qualifies
        else:
            if num_trial > WINDOW_SIZE:
                window_frame = window + 3 * WINDOW_SIZE // 4
            else:
                window_frame = window
            if delayed_feedback == "delay":
                sum_tp, sum_psr, size = s.tx_window_known_sums(window_frame)
                known_tp = sum_tp / size if size else 0.0
            else:
                known_tp, _ = s.rx_window_means(window)
            if known_tp > throughput_threshold and len(trainees) > 0:
                idx_vals = s.gittins_index[trainees]
                hi = np.max(idx_vals)
                ids = trainees[idx_vals == hi] + 1
                chosen = self._random_choice(ids)
            else:
                q_upper = s.alg_upper[qualified]
                chosen = int(qualified[np.argmax(q_upper)]) + 1
        self._post_delay("RoTA", chosen, num_trial, delayed_feedback, delayed_strategy)
        c = _conf(chosen)
        return c, c

    # keep the reference's capitalized name too
    RoTA = rota
