"""The cognitive-engine block, which closes the adaptation loop.

Counterpart of ``liquiddsp_tpu/engine/cognitive_engine.py``. It runs on the
host: see the package docstring.

Re-implements the reference's GR-block handler (python/cognitive_engine.py:
39-167) as a host-side component with the same message contract:

  packet_info {header_valid, payload_valid, modulation, inner_code,
  outer_code} -> handler -> configuration {modulation, inner_code, outer_code}

per-packet flow (reference py:78-149):
  config_id = m*56 + i*8 + o + 1; goodput = log2(M)*r_out*r_in*payload_valid;
  write stats (immediate or delayed-reconciled); log RX; optionally update
  knowledge indicators; run the selected bandit; publish the next config.

Constructor parameters mirror the GRC descriptor enums
(grc/liquiddsp_cognitive_engine.xml:8-123): ce_type {epsilon_greedy,
annealing_epsilon_greedy, gittins, RoTA, meta}, delayed_feedback {no_delay,
delay}, delayed_strategy {lower, mean, upper}, channel {stationary,
nonstationary}, kindicator {off, on}, contextual_type {none, context_lbi,
context_rbi, context_cci, context_ci}, noise (amplitude).

The hard-coded dynamic-noise schedule get_number() (py:151-167) is kept for
fault-injection parity (SURVEY.md section 5.3).
"""

from __future__ import annotations

import math
import random

from liquiddsp_tpu_torch.core.config import ConfigurationMap, config_id as make_config_id
from liquiddsp_tpu_torch.engine.bandits import CognitiveEngine
from liquiddsp_tpu_torch.engine.knowledge import KnowledgeIndicator
from liquiddsp_tpu_torch.engine.store import ArmStore

EPSILON = 0.1  # handler-local epsilon (reference py:80)
DISCOUNT = 0.9  # reference py:81
PSR_THRESHOLD = 0.6  # reference py:75
THROUGHPUT_THRESHOLD = 1.5  # reference py:76
INITIAL_EPSILON = 0.4  # reference py:72


class CognitiveEngineBlock:
    def __init__(
        self,
        ce_type: str = "epsilon_greedy",
        delayed_feedback: str = "no_delay",
        delayed_strategy: str = "mean",
        channel: str = "stationary",
        kindicator: str = "off",
        contextual_type: str = "none",
        noise: float = 0.0,
        seed: int | None = None,
        verbose: bool = False,
    ):
        self.ce_type = ce_type
        self.delayed_feedback = delayed_feedback
        self.delayed_strategy = delayed_strategy
        self.channel = channel
        self.kindicator = kindicator
        self.contextual_type = contextual_type
        # contextual mode forces indicators on + epsilon-greedy (py:54-56)
        if self.contextual_type != "none":
            self.kindicator = "on"
            self.ce_type = "epsilon_greedy"
        self.dynamic_noise = 0.0
        self.noise = noise if channel == "stationary" else self.dynamic_noise
        self.verbose = verbose

        self.store = ArmStore(channel=channel)
        self.engine = CognitiveEngine(self.store, random.Random(seed))
        self.knowledge = KnowledgeIndicator(self.store)
        self.num_packets = 0
        self.initial_epsilon = INITIAL_EPSILON

    # -- the packet_info handler (py:78-149) --------------------------------

    def handler(self, packet_info: dict) -> dict | None:
        """Consume one packet_info dict; return the next configuration dict
        (the ``configuration`` message the reference publishes at py:142-149)."""
        self.num_packets += 1
        modulation = int(packet_info["modulation"])
        inner_code = int(packet_info["inner_code"])
        outer_code = int(packet_info["outer_code"])
        payload_valid = float(packet_info["payload_valid"])
        header_valid = float(packet_info.get("header_valid", 1))

        cid = make_config_id(modulation, inner_code, outer_code)
        cmap = ConfigurationMap(modulation, inner_code, outer_code, cid)
        goodput = (
            math.log2(cmap.constellationN)
            * cmap.outercodingrate
            * cmap.innercodingrate
            * payload_valid
        )

        if modulation >= 0 and inner_code >= 0 and outer_code >= 0:
            if self.delayed_feedback == "no_delay":
                self.store.write_configuration(
                    self.ce_type, cid, header_valid, payload_valid, goodput, 0.0
                )
            else:
                self.store.write_delayed_feedback(
                    self.ce_type, cid, header_valid, payload_valid, goodput
                )
        self.store.write_rx_result(cid, self.num_packets, goodput, payload_valid)

        if self.kindicator == "on":
            self.knowledge.compute(self.num_packets, self.contextual_type)

        return self._decide()

    def _decide(self) -> dict:
        """Run the selected bandit once and log the TX decision (the tail
        of the reference handler, py:110-149)."""
        args = (self.delayed_feedback, self.delayed_strategy, self.channel)
        if self.ce_type == "epsilon_greedy":
            eps = EPSILON if self.contextual_type == "none" else self.knowledge.c_epsilon
            conf, _ = self.engine.epsilon_greedy(self.num_packets, eps, *args)
        elif self.ce_type == "gittins":
            conf, _ = self.engine.gittins(self.num_packets, DISCOUNT, *args)
        elif self.ce_type == "annealing_epsilon_greedy":
            conf, _ = self.engine.annealing_epsilon_greedy(
                self.num_packets, self.initial_epsilon, *args
            )
            if self.initial_epsilon > 0.05:  # anneal (py:125-126)
                self.initial_epsilon -= 0.001
        elif self.ce_type == "RoTA":
            conf, _ = self.engine.rota(
                self.num_packets, THROUGHPUT_THRESHOLD, PSR_THRESHOLD, *args
            )
        elif self.ce_type == "meta":
            # BCAC: switch algorithm by current SNR (py:129-139)
            snr = self.current_snr_db()
            if snr is not None and snr < 12:
                conf, _ = self.engine.epsilon_greedy(self.num_packets, EPSILON, *args)
            elif snr is not None and snr < 18:
                conf, _ = self.engine.annealing_epsilon_greedy(
                    self.num_packets, self.initial_epsilon, *args
                )
            else:
                conf, _ = self.engine.gittins(self.num_packets, DISCOUNT, *args)
        else:
            raise ValueError(f"unknown ce_type {self.ce_type!r}")

        if self.delayed_feedback == "no_delay":
            self.store.write_tx_result(
                conf.conf_id, self.num_packets, self.delayed_feedback, self.delayed_strategy
            )
        if self.verbose:
            print(
                f"packet {self.num_packets}: chose config {conf.conf_id} "
                f"(mod={conf.modulation} inner={conf.inner_code} outer={conf.outer_code})"
            )
        return {
            "modulation": conf.modulation,
            "inner_code": conf.inner_code,
            "outer_code": conf.outer_code,
        }

    def handle_batch(self, packet_infos: list[dict]) -> list[dict]:
        """Consume one GENERATION of packet_info dicts in a single
        vectorized pass; return one next-configuration dict per packet.

        The closed batched loop (``liquiddsp_tpu_torch.adapt_loop``: 64
        channels per generation) would call :meth:`handler` per packet,
        and each call pays a confidence-interval recompute on
        1-element arrays (SURVEY.md section 3's 616-arm scan analog). Here
        every packet's arm update FOLDS first (store._fold_update — the
        final store state is bit-identical to sequential handler calls,
        see store.refresh_ci), the CI columns refresh once vectorized over
        the touched arms, the knowledge indicators compute once per
        generation, and the per-packet bandit decisions then run against
        the post-batch state. Decision semantics: all of a generation's
        decisions see the full generation's feedback (the scalar handler
        interleaves) — indistinguishable in the closed loop, where
        feedback is at least one generation delayed anyway.
        """
        if self.delayed_feedback != "no_delay":
            # delayed mode interleaves decisions (which append pending
            # substituted-reward entries) with reconciliations that pop
            # them — batching would starve the reconciliation queue and
            # diverge from the reference protocol. Stay sequential.
            return [self.handler(info) for info in packet_infos]
        arms: list[int] = []
        for info in packet_infos:
            self.num_packets += 1
            modulation = int(info["modulation"])
            inner_code = int(info["inner_code"])
            outer_code = int(info["outer_code"])
            payload_valid = float(info["payload_valid"])
            header_valid = float(info.get("header_valid", 1))
            cid = make_config_id(modulation, inner_code, outer_code)
            cmap = ConfigurationMap(modulation, inner_code, outer_code, cid)
            goodput = (
                math.log2(cmap.constellationN)
                * cmap.outercodingrate
                * cmap.innercodingrate
                * payload_valid
            )
            if modulation >= 0 and inner_code >= 0 and outer_code >= 0:
                if self.delayed_feedback == "no_delay":
                    self.store._fold_update(
                        self.ce_type, cid, header_valid, payload_valid, goodput, 0.0
                    )
                    arms.append(cid - 1)
                else:
                    # delayed reconciliation pops per-entry state; keep the
                    # scalar path (refresh per call) for exact parity
                    self.store.write_delayed_feedback(
                        self.ce_type, cid, header_valid, payload_valid, goodput
                    )
            self.store.write_rx_result(cid, self.num_packets, goodput, payload_valid)
        if arms:
            self.store.refresh_ci(arms, self.ce_type)
        if self.kindicator == "on":
            self.knowledge.compute(self.num_packets, self.contextual_type)
        return [self._decide() for _ in packet_infos]

    def current_snr_db(self) -> float | None:
        """SNR from the dynamic-noise amplitude (reference py:90-92, 130-131)."""
        if self.dynamic_noise > 0:
            return float(10 * math.log10((0.05 / (2 * self.dynamic_noise)) ** 2))
        return None

    def get_number(self) -> float:
        """The hard-coded dynamic-noise schedule stepping at packet counts
        757/1267/1417 (reference py:151-167) — channel fault injection."""
        if self.num_packets < 757:
            self.dynamic_noise = 0.006
        elif self.num_packets < 1267:
            self.dynamic_noise = 0.01
        elif self.num_packets < 1417:
            self.dynamic_noise = 0.004
        else:
            self.dynamic_noise = 0.008
        return self.dynamic_noise
