"""The cognitive engine of the PyTorch port (its own copy, on the host)
against the JAX package's: bit-exact.

Each case drives both engines through the same closed loop of 300 packets,
once packet by packet (``handler``) and once in generations of 20
(``handle_batch``): the engine's decision is the next packet's config on
that channel, and whether a packet succeeds is drawn from a seeded numpy
generator (likely where the config's goodput bound is below a capacity of
3 bit/symbol, unlikely above; a few packets are lost and report a failure
on the config they were sent with). The two packages must make the same
decisions packet by packet and end with equal arm arrays
(``np.array_equal``), logs, pending substitutions and indicator logs."""

import dataclasses
import sqlite3

import numpy as np
import pytest

from liquiddsp_tpu.core.config import ConfigurationMap as JConfigurationMap
from liquiddsp_tpu.engine import estimators as jestimators
from liquiddsp_tpu.engine.cognitive_engine import CognitiveEngineBlock as JBlock
from liquiddsp_tpu.engine.store import ArmStore as JArmStore
from liquiddsp_tpu_torch import engine
from liquiddsp_tpu_torch.engine import estimators
from liquiddsp_tpu_torch.engine.cognitive_engine import CognitiveEngineBlock
from liquiddsp_tpu_torch.engine.store import ArmStore

N_PACKETS, GENERATION, CAPACITY = 300, 20, 3.0
CE_TYPES = ("epsilon_greedy", "annealing_epsilon_greedy", "gittins", "RoTA", "meta")
FEEDBACK = (("no_delay", "mean"), ("delay", "lower"), ("delay", "mean"), ("delay", "upper"))
CHANNELS = ("stationary", "nonstationary")
CONTEXTUAL = ("context_lbi", "context_rbi", "context_cci", "context_ci")
GRID = [
    pytest.param(ce, fb, ch, ki, ctx, id=f"{ce}-{fb[0]}-{fb[1]}-{ch}-{ki}-{ctx}")
    for ce, fb, ch, ki, ctx in (
        [(ce, fb, ch, ki, "none") for ki in ("off", "on") for ce in CE_TYPES for fb in FEEDBACK
         for ch in CHANNELS]
        # a contextual mode forces epsilon_greedy with the indicators on
        + [("epsilon_greedy", fb, ch, "on", ctx) for ctx in CONTEXTUAL for fb in FEEDBACK
           for ch in CHANNELS])
]
STORE_ARRAYS = ("trial_n", "total", "success", "throughput_sum", "sqth", "lb_throughput",
                "ub_throughput", "psr", "lb_psr", "ub_psr", "mean_throughput", "variance",
                "alg_mean", "alg_lower", "alg_upper", "alg_trials", "eligibility",
                "gittins_index", "stdv", "upper_bound")


def make(block_cls, ce_type, fb, channel, kindicator, contextual, seed=3):
    return block_cls(ce_type=ce_type, delayed_feedback=fb[0], delayed_strategy=fb[1],
                     channel=channel, kindicator=kindicator, contextual_type=contextual, seed=seed)


def outcome(rng, cfg) -> dict:
    m, i, o = cfg["modulation"], cfg["inner_code"], cfg["outer_code"]
    ub = JConfigurationMap(m, i, o).goodput_upper_bound
    lost = rng.random() < 0.05
    ok = not lost and rng.random() < (0.9 if ub <= CAPACITY else 0.15)
    hdr = not lost and (ok or rng.random() < 0.6)
    return {"header_valid": int(hdr), "payload_valid": int(ok), "modulation": m,
            "inner_code": i, "outer_code": o}


def drive(block, batched: bool) -> list:
    """The closed loop over GENERATION channels; returns every decision."""
    rng = np.random.default_rng(11)
    cfgs = [{"modulation": 1, "inner_code": 0, "outer_code": 0}] * GENERATION
    decisions = []
    for _ in range(N_PACKETS // GENERATION):
        if block.ce_type == "meta":
            block.get_number()  # the SNR that switches meta's algorithm
        infos = [outcome(rng, c) for c in cfgs]
        if batched:
            out = block.handle_batch(infos)
        else:
            out = [block.handler(info) for info in infos]
        decisions.extend(out)
        cfgs = out
    return decisions


def state_of(block) -> dict:
    s = block.store
    return {
        "arrays": {k: getattr(s, k) for k in STORE_ARRAYS},
        "tx": [dataclasses.astuple(e) for e in s.tx_log],
        "rx": [dataclasses.astuple(e) for e in s.rx_log],
        "ki": list(s.ki_log),
        "pending": {k: [dataclasses.astuple(e) for e in q] for k, q in s.pending.items() if q},
        "scalars": (block.num_packets, block.initial_epsilon, block.knowledge.c_epsilon,
                    s.initial_entropy, block.ce_type, block.kindicator),
    }


def assert_same_state(got: dict, ref: dict):
    for k, a in ref["arrays"].items():
        assert got["arrays"][k].dtype == a.dtype, k
        assert np.array_equal(got["arrays"][k], a), k
    for k in ("tx", "rx", "ki", "pending", "scalars"):
        assert got[k] == ref[k], k


@pytest.mark.parametrize("ce_type,fb,channel,kindicator,contextual", GRID)
def test_engine_bit_exact_with_jax(ce_type, fb, channel, kindicator, contextual):
    for batched in (False, True):
        mine = make(CognitiveEngineBlock, ce_type, fb, channel, kindicator, contextual)
        ref = make(JBlock, ce_type, fb, channel, kindicator, contextual)
        assert drive(mine, batched) == drive(ref, batched), batched
        assert_same_state(state_of(mine), state_of(ref))
        assert mine.store.rx_log and mine.store.tx_log


def test_estimators_equal_jax():
    rng = np.random.default_rng(2)
    n = rng.integers(0, 3000, 616)
    mean, var, maxp = rng.random(616) * 4, rng.random(616), rng.random(616) * 6
    for got, ref in ((estimators.throughput_ci(mean, var, maxp, n),
                      jestimators.throughput_ci(mean, var, maxp, n)),
                     (estimators.psr_ci(n * 0.7, n * 0.3), jestimators.psr_ci(n * 0.7, n * 0.3))):
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)
    counts = np.concatenate([np.arange(1, 60), rng.integers(1, 20000, 100)])
    for disc in (0.5, 0.9, 0.97, 0.995):
        assert np.array_equal(estimators.gittins_index_normal_unit_var(counts, disc),
                              jestimators.gittins_index_normal_unit_var(counts, disc))
        assert estimators.gittins_index_normal_unit_var(7, disc) == \
            jestimators.gittins_index_normal_unit_var(7, disc)
    assert engine.ArmStore is ArmStore and engine.CognitiveEngine and engine.KnowledgeIndicator


def played(block_cls):
    block = make(block_cls, "gittins", ("no_delay", "mean"), "nonstationary", "on", "none")
    drive(block, batched=True)
    return block


@pytest.mark.parametrize("writer,reader", [(CognitiveEngineBlock, JArmStore),
                                           (JBlock, ArmStore)])
def test_store_npz_loads_in_the_other_package(tmp_path, writer, reader):
    src = played(writer).store
    path = str(tmp_path / "arms")
    src.save(path)
    dst = reader()
    dst.load(path)
    for k in STORE_ARRAYS:
        a, b = getattr(src, k), getattr(dst, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_export_sqlite_rows_equal_jax(tmp_path):
    rows = []
    for block_cls, name in ((CognitiveEngineBlock, "port.db"), (JBlock, "jax.db")):
        path = str(tmp_path / name)
        played(block_cls).store.export_sqlite(path)
        con = sqlite3.connect(path)
        rows.append({t: con.execute(f"select * from {t} order by 1").fetchall()
                     for t in ("CONFIG", "tx", "rx", "KI", "rules1")})
        con.close()
    assert rows[0] == rows[1]
    assert len(rows[0]["CONFIG"]) == 616 and len(rows[0]["rx"]) == N_PACKETS
