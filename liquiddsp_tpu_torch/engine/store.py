"""Arm-statistics store: the reference DatabaseControl's role
(python/cognitive_engine.py:169-553) as a single-owner, vectorized state.

Counterpart of ``liquiddsp_tpu/engine/store.py`` (host numpy); its npz
files load in either package.

The reference keeps arm statistics in sqlite tables (CONFIG + per-algorithm
Egreedy/Annealing_Egreedy/Gittins/RoTA + tx/rx decision logs + KI) accessed
through three *separate* connections — a latent write-skew hazard SURVEY.md
section 5.2 flags. Here one ``ArmStore`` owns all adaptation state as numpy
arrays over the 616-arm axis; persistence is an explicit ``save``/``load``
(npz) plus an optional sqlite export mirroring the reference schema for
checkpoint/resume parity (SURVEY.md section 5.4).

Update semantics mirror ``write_configuration`` (reference py:233-341):
incremental mean/variance in stationary channels, EWMA with alpha=0.2 in
nonstationary ones (py:275-293), Student-t throughput CIs, beta-posterior PSR
CIs, Gittins indices; and the delayed-feedback substitution/reconciliation
protocol of write_TX_result / write_delayed_feedback (py:189-231).
"""

from __future__ import annotations

import dataclasses
import sqlite3
from collections import defaultdict, deque

import numpy as np

from liquiddsp_tpu_torch.core.config import (
    NUM_CONFIGS,
    ConfigurationMap,
    config_from_id,
)
from liquiddsp_tpu_torch.engine import estimators

ALPHA = 0.2  # EWMA factor (reference py:33)
DISCOUNT = 0.9  # Gittins discount (reference py:31)


def goodput_upper_bounds() -> np.ndarray:
    """[616] per-arm goodput upper bound log2(M)*r_out*r_in (reference py:365)."""
    ub = np.empty(NUM_CONFIGS)
    for cid in range(1, NUM_CONFIGS + 1):
        m, i, o = config_from_id(cid)
        ub[cid - 1] = ConfigurationMap(m, i, o, cid).goodput_upper_bound
    return ub


@dataclasses.dataclass
class TxLogEntry:
    num_packets: int
    config_id: int
    psr: float
    sub_value: float
    over_write: int
    known_mean: float
    known_psr: float


@dataclasses.dataclass
class RxLogEntry:
    num_packets: int
    config_id: int
    throughput: float
    psr: float


class ArmStore:
    """All adaptation state for one engine instance. Arm arrays are indexed
    by conf_id - 1 (0..615)."""

    def __init__(self, channel: str = "stationary"):
        self.channel = channel
        self.upper_bound = goodput_upper_bounds()
        self.reset()

    def reset(self):
        """reset_config_tables + reset_cognitive_engine_tables analog
        (reference py:343-553): zero stats, seed per-arm priors."""
        n = NUM_CONFIGS
        self.trial_n = np.zeros(n, dtype=np.int64)
        self.total = np.zeros(n, dtype=np.int64)
        self.success = np.zeros(n, dtype=np.float64)
        self.throughput_sum = np.zeros(n)
        self.sqth = np.zeros(n)
        self.lb_throughput = np.zeros(n)
        self.ub_throughput = self.upper_bound.copy()  # prior: goodput bound
        self.psr = np.ones(n)
        self.lb_psr = np.zeros(n)
        self.ub_psr = np.ones(n)
        self.mean_throughput = np.zeros(n)
        self.variance = np.zeros(n)
        # per-algorithm views (reference keeps separate tables seeded the
        # same way: Mean=0, Lower=0, Upper=goodput bound, Eligibility=1)
        self.alg_mean = np.zeros(n)
        self.alg_lower = np.zeros(n)
        self.alg_upper = self.upper_bound.copy()
        self.alg_trials = np.zeros(n, dtype=np.int64)
        self.eligibility = np.ones(n, dtype=np.int64)
        self.gittins_index = self.upper_bound.copy()  # prior index = bound
        self.stdv = np.zeros(n)
        # decision logs (tx/rx tables, reference py:475-485)
        self.tx_log: list[TxLogEntry] = []
        self.rx_log: list[RxLogEntry] = []
        # outstanding substituted rewards per config (tx rows, over_write=0)
        self.pending: dict[int, deque] = defaultdict(deque)
        # knowledge-indicator log (KI table, py:488-492)
        self.ki_log: list[tuple[int, float, float, float, float]] = []
        # initial entropy seed (reference py:493-501)
        bw = 100.0
        self.initial_entropy = float(
            np.sum(np.log(bw * (self.ub_throughput - self.lb_throughput)))
        )

    # -- decision logs ------------------------------------------------------

    def write_rx_result(self, config_id: int, num_packets: int, throughput: float, psr: float):
        """reference write_RX_result (py:180-187)."""
        self.rx_log.append(RxLogEntry(num_packets, config_id, throughput, psr))

    def write_tx_result(
        self, config_id: int, num_packets: int, delayed_feedback: str, delayed_strategy: str
    ):
        """reference write_TX_result (py:189-214): log the decision; in
        delayed mode record the substituted reward for later reconciliation."""
        a = config_id - 1
        if self.total[a] > 0:
            mean = self.throughput_sum[a] / self.total[a]
        else:
            mean = 0.0
        if delayed_feedback == "no_delay":
            sub_value, psr = -1.0, -1.0
        else:
            if delayed_strategy == "mean":
                sub_value = (
                    self.throughput_sum[a] / self.total[a]
                    if self.total[a] > 0
                    else (self.lb_throughput[a] + self.ub_throughput[a]) / 2.0
                )
            elif delayed_strategy == "lower":
                sub_value = self.lb_throughput[a]
            else:  # upper
                sub_value = self.ub_throughput[a]
            psr = self.psr[a]
        entry = TxLogEntry(num_packets, config_id, psr, sub_value, 0, mean, self.psr[a])
        self.tx_log.append(entry)
        if delayed_feedback == "delay":
            self.pending[config_id].append(entry)

    # -- arm statistics -----------------------------------------------------

    def write_configuration(
        self,
        ce_type: str,
        config_id: int,
        total: float,
        success: float,
        throughput: float,
        sub_value: float,
    ):
        """reference write_configuration (py:233-341), one arm update.

        ``success < 0`` marks a delayed-feedback reconciliation (the caller
        passes d_PSR = payload_valid - 2 and d_goodput = goodput - sub_value,
        reference py:225-229): the substituted reward is backed out of the
        running sums before the true reward is folded in.

        Implemented as a cheap sequential fold (:meth:`_fold_update`) plus
        a confidence-interval refresh (:meth:`refresh_ci`). The CI values
        depend only on the CURRENT running sums, so a batch of updates may
        fold first and refresh once — bit-identical final state to N
        sequential calls (the batched-generation handler's contract,
        CognitiveEngineBlock.handle_batch).
        """
        self._fold_update(ce_type, config_id, total, success, throughput, sub_value)
        self.refresh_ci([config_id - 1], ce_type)

    def _fold_update(
        self,
        ce_type: str,
        config_id: int,
        total: float,
        success: float,
        throughput: float,
        sub_value: float,
    ):
        """Running-sum / mean / variance part of one arm update (everything
        except the deferred-able CI and Gittins-index columns)."""
        a = config_id - 1
        num_trial = int(self.trial_n[a])
        old_throughput = self.throughput_sum[a]
        old_sqth = self.sqth[a]

        new_trial = num_trial + 1
        new_total = int(self.total[a] + total)
        if success < 0:
            new_success = self.success[a] + success + 1
        else:
            new_success = self.success[a] + success
        new_tp_sum = old_throughput + throughput
        if throughput < 0:
            adj_sqth = old_sqth - sub_value**2
            new_sqth = adj_sqth + (sub_value + throughput) ** 2
        else:
            new_sqth = old_sqth + throughput**2
        new_psr = (new_success + 1.0) / (new_total + 2.0)

        mean = self.mean_throughput[a]
        variance = self.variance[a]
        if new_total == 1:
            mean = new_tp_sum / new_total
            variance = new_sqth / new_total - mean**2
        elif new_total > 1:
            if self.channel == "stationary" or new_total <= 1.0 / ALPHA:
                mean = new_tp_sum / new_total
                variance = new_sqth / new_total - mean**2
            else:  # nonstationary EWMA (py:275-293)
                if success < 0:
                    ot = old_throughput - sub_value
                    old_mean = ot / num_trial
                    diff = throughput + sub_value - old_mean
                    osq = old_sqth - sub_value**2
                    mean = old_mean + ALPHA * diff
                    old_var = osq / num_trial - old_mean**2
                    variance = (1 - ALPHA) * (old_var + ALPHA * diff**2)
                else:
                    old_mean = old_throughput / num_trial
                    diff = throughput - old_mean
                    mean = old_mean + ALPHA * diff
                    old_var = old_sqth / num_trial - old_mean**2
                    variance = (1 - ALPHA) * (old_var + ALPHA * diff**2)
            variance = max(variance, 0.0)

        self.trial_n[a] = new_trial
        self.total[a] = new_total
        self.success[a] = new_success
        self.throughput_sum[a] = new_tp_sum
        self.sqth[a] = new_sqth
        self.psr[a] = new_psr
        self.mean_throughput[a] = mean
        self.variance[a] = variance
        if new_total == 1:
            # reference leaves UB at its prior for N=1 (py:269-270)
            self.lb_throughput[a] = 0.0

        # per-algorithm table updates (py:304-339; CI columns in refresh_ci)
        self.alg_trials[a] = new_total
        self.alg_mean[a] = mean

    def refresh_ci(self, arms, ce_type: str):
        """Recompute the confidence-interval (and Gittins) columns for the
        given arm indices from their CURRENT sums — vectorized over arms.

        Sequential write_configuration calls recompute these on every
        update, but each recompute reads only the running sums, so only
        the LAST one per arm survives: folding a batch first and
        refreshing once is bit-identical (reference py:255-339 column
        semantics preserved: N=1 keeps the prior throughput UB; the
        per-algorithm lower/upper and Gittins columns only move past
        N=1)."""
        a = np.unique(np.asarray(arms, dtype=np.int64))
        s = self.success[a]
        lb_p, ub_p = estimators.psr_ci(s, self.trial_n[a] - s)
        self.lb_psr[a] = lb_p
        self.ub_psr[a] = ub_p
        nt = self.total[a]
        m2 = nt > 1
        if m2.any():
            aa = a[m2]
            lo, hi = estimators.throughput_ci(
                self.mean_throughput[aa], self.variance[aa],
                self.upper_bound[aa], self.total[aa],
            )
            self.lb_throughput[aa] = lo
            self.ub_throughput[aa] = hi
            self.alg_lower[aa] = lo
            self.alg_upper[aa] = hi
            if ce_type in ("gittins", "RoTA"):
                stdv = np.sqrt(self.variance[aa])
                self.stdv[aa] = stdv
                self.gittins_index[aa] = (
                    self.mean_throughput[aa]
                    + stdv
                    * estimators.gittins_index_normal_unit_var(
                        self.total[aa], DISCOUNT
                    )
                )

    def write_delayed_feedback(
        self, ce_type: str, config_id: int, header_valid: float, payload_valid: float, goodput: float
    ):
        """reference write_delayed_feedback (py:216-231): reconcile the oldest
        outstanding substituted reward for this config, or do a normal write."""
        q = self.pending.get(config_id)
        if q:
            while q:
                entry = q.popleft()
                entry.over_write = 1
                d_psr = payload_valid - 2.0
                d_goodput = goodput - entry.sub_value
                self.write_configuration(
                    ce_type, config_id, 0.0, d_psr, d_goodput, entry.sub_value
                )
        else:
            self.write_configuration(
                ce_type, config_id, header_valid, payload_valid, goodput, 0.0
            )

    # -- windowed aggregates for RoTA (py:1012-1015, 1066-1080) -------------

    def rx_window_means(self, after_packet: int) -> tuple[float, float]:
        rows = [r for r in self.rx_log if r.num_packets > after_packet]
        if not rows:
            return 0.0, 0.0
        return (
            float(np.mean([r.throughput for r in rows])),
            float(np.mean([r.psr for r in rows])),
        )

    def tx_window_known_sums(self, after_packet: int) -> tuple[float, float, int]:
        rows = [r for r in self.tx_log if r.num_packets > after_packet]
        return (
            float(sum(r.known_mean for r in rows)),
            float(sum(r.known_psr for r in rows)),
            len(rows),
        )

    # -- persistence (SURVEY.md section 5.4) --------------------------------

    def save(self, path: str):
        np.savez(
            path,
            trial_n=self.trial_n, total=self.total, success=self.success,
            throughput_sum=self.throughput_sum, sqth=self.sqth,
            lb_throughput=self.lb_throughput, ub_throughput=self.ub_throughput,
            psr=self.psr, lb_psr=self.lb_psr, ub_psr=self.ub_psr,
            mean_throughput=self.mean_throughput, variance=self.variance,
            alg_mean=self.alg_mean, alg_lower=self.alg_lower,
            alg_upper=self.alg_upper, alg_trials=self.alg_trials,
            eligibility=self.eligibility, gittins_index=self.gittins_index,
            stdv=self.stdv,
        )

    def load(self, path: str):
        data = np.load(path if str(path).endswith(".npz") else path + ".npz")
        for k in data.files:
            setattr(self, k, data[k])

    def export_sqlite(self, path: str):
        """Mirror the reference's CONFIG/tx/rx/KI schema (py:503-553, 475-492)
        into a sqlite file, for tooling parity."""
        conn = sqlite3.connect(path)
        cur = conn.cursor()
        cur.execute("drop table if exists CONFIG")
        cur.execute(
            "CREATE TABLE CONFIG (ID INT PRIMARY KEY, MODULATION INT, Innercode INT,"
            " Outercode INT, TrialN INT, Total INT, Success INT, Throughput REAL,"
            " SQTh REAL, LB_Throughput REAL, UB_Throughput REAL, PSR REAL,"
            " LB_PSR REAL, UB_PSR REAL, Mean_Throughput REAL)"
        )
        for cid in range(1, NUM_CONFIGS + 1):
            a = cid - 1
            m, i, o = config_from_id(cid)
            cur.execute(
                "INSERT INTO CONFIG VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (cid, m, i, o, int(self.trial_n[a]), int(self.total[a]),
                 float(self.success[a]), float(self.throughput_sum[a]),
                 float(self.sqth[a]), float(self.lb_throughput[a]),
                 float(self.ub_throughput[a]), float(self.psr[a]),
                 float(self.lb_psr[a]), float(self.ub_psr[a]),
                 float(self.mean_throughput[a])),
            )
        cur.execute("drop table if exists tx")
        cur.execute(
            "create table tx (num_packets integer primary key, config_id integer,"
            " PSR real, sub_value real, over_write bit, known_mean real, known_PSR real)"
        )
        for e in self.tx_log:
            cur.execute(
                "INSERT OR REPLACE INTO tx VALUES (?,?,?,?,?,?,?)",
                (e.num_packets, e.config_id, e.psr, e.sub_value, e.over_write,
                 e.known_mean, e.known_psr),
            )
        cur.execute("drop table if exists rx")
        cur.execute(
            "create table rx (num_packets integer primary key, config_id integer,"
            " throughput float, PSR float)"
        )
        for e in self.rx_log:
            cur.execute(
                "INSERT OR REPLACE INTO rx VALUES (?,?,?,?)",
                (e.num_packets, e.config_id, e.throughput, e.psr),
            )
        cur.execute("drop table if exists KI")
        cur.execute(
            "create table KI (num_packets integer primary key, LBI real, RBI real,"
            " CCI real, CI real)"
        )
        for row in self.ki_log:
            cur.execute("INSERT OR REPLACE INTO KI VALUES (?,?,?,?,?)", row)
        # rules1: vestigial two-row seed table the reference creates in
        # rules.db (py:539-552) — kept for schema parity
        cur.execute("drop table if exists rules1")
        cur.execute(
            "CREATE TABLE rules1 (idd INT PRIMARY KEY NOT NULL, ID INT NOT NULL,"
            " MODULATION INT NOT NULL, Innercode INT NOT NULL, Outercode INT NOT NULL)"
        )
        cur.execute("INSERT INTO rules1 VALUES (1, 1, 0, 0, 0)")
        cur.execute("INSERT INTO rules1 VALUES (2, 2, 0, 0, 0)")
        conn.commit()
        conn.close()
