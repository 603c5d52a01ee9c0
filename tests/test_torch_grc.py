"""The PyTorch port's flowgraph layer (liquiddsp_tpu_torch/grc): its YAML
descriptors parse and name classes of the port, parameters are typed and
validated, the loopback graph decodes every packet bit-exactly against the
source, the adaptation graph closes the loop and its packet infos, replayed
into the JAX package's engine, give the engine's decisions; a bad
connection raises (tests/test_grc_loader.py's cases, mirrored on the port,
every block on the CPU)."""

import glob
import importlib
import os
import random

import numpy as np
import pytest
import torch

from liquiddsp_tpu.engine.cognitive_engine import CognitiveEngineBlock as JBlock
from liquiddsp_tpu_torch.grc import loader
from liquiddsp_tpu_torch.grc.loader import GRAPHS_DIR, BlockDescriptor, Flowgraph

GRC_DIR = os.path.dirname(loader.__file__)
DESCRIPTORS = sorted(glob.glob(os.path.join(GRC_DIR, "*.yaml")))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def graph(name):
    return Flowgraph.load(os.path.join(GRAPHS_DIR, f"{name}.yaml"), device="cpu")


class TestDescriptors:
    def test_the_six_descriptors_and_two_graphs_are_there(self):
        names = {os.path.basename(p)[:-5] for p in DESCRIPTORS}
        assert names == {"channel_model", "cognitive_engine", "flex_rx", "flex_tx",
                         "frame_detector_cc", "packet_source"}
        assert sorted(os.listdir(GRAPHS_DIR)) == ["adaptation_loop.yaml", "loopback.yaml"]

    @pytest.mark.parametrize("path", DESCRIPTORS, ids=os.path.basename)
    def test_descriptor_parses_and_names_a_port_class(self, path):
        d = BlockDescriptor.load(path)
        assert d.factory.startswith("liquiddsp_tpu_torch.")
        mod, cls = d.factory.rsplit(".", 1)
        factory = getattr(importlib.import_module(mod), cls)
        assert callable(factory), d.id
        for port in d.inputs.values():
            assert port.handler and hasattr(factory, port.handler), f"{d.id}.{port.id}"

    @pytest.mark.parametrize("name", ["flex_tx", "flex_rx", "frame_detector_cc", "channel_model"])
    def test_device_reaches_the_factories_that_take_one(self, name):
        blk = BlockDescriptor.load(name).instantiate(device="cpu")
        assert blk.device == torch.device("cpu")

    def test_typed_parameter_coercion_and_validation(self):
        d = BlockDescriptor.load("flex_tx")
        tx = d.instantiate({"modulation": "3"}, device="cpu")  # coerced int
        assert tx.modulation == 3
        with pytest.raises(ValueError):
            d.instantiate({"bogus_param": 1}, device="cpu")
        ce = BlockDescriptor.load("cognitive_engine")
        with pytest.raises(ValueError):
            ce.instantiate({"ce_type": "not_an_algorithm"})
        ch = BlockDescriptor.load("channel_model").instantiate({"snr_db": "12"}, device="cpu")
        assert ch.snr_db == 12.0 and isinstance(ch.snr_db, float)

    @pytest.mark.parametrize("ce_type", ["gittins", "RoTA", "meta"])
    def test_enum_parameter_accepted(self, ce_type):
        blk = BlockDescriptor.load("cognitive_engine").instantiate({"ce_type": ce_type})
        assert blk.ce_type == ce_type


class TestFlowgraphs:
    def test_loopback_graph_decodes_all_packets_bit_exact(self):
        fg = graph("loopback")
        src, rx = fg.blocks["src"], fg.blocks["rx"]
        got = []
        rx.bus.subscribe("payload_data", lambda pdu: got.append(np.asarray(pdu.data)))
        fg.run(8)
        assert rx.num_packets == 8 and len(src.sent) == 8 and len(got) == 8
        for sent, rec in zip(src.sent, got):
            assert np.array_equal(sent, rec)

    def test_adaptation_loop_closes_and_replays_into_the_jax_engine(self):
        fg = graph("adaptation_loop")
        tx, ce = fg.blocks["tx"], fg.blocks["ce"]
        ce.engine.rng = random.Random(0)  # the graph's engine is unseeded
        infos, decisions = [], []
        fg.blocks["rx"].bus.subscribe("packet_info", infos.append)
        fg.nodes["ce"].wires["configuration"].append(decisions.append)
        commanded = []
        for _ in range(40):
            commanded.append((tx.modulation, tx.inner_code, tx.outer_code))
            fg.run(1)
        assert ce.num_packets == len(infos) == len(decisions) > 0
        # the engine's configuration messages retune the TX
        assert commanded[1:] != [commanded[0]] * 39
        ref = JBlock(ce_type="epsilon_greedy", seed=0)
        for info, conf in zip(infos, decisions):
            assert ref.handler(info) == conf
        tail = [r.throughput for r in ce.store.rx_log[-20:]]
        assert np.mean(tail) > 0.5

    def test_connection_errors_are_loud(self):
        fg = graph("loopback")
        with pytest.raises(KeyError):
            fg._connect("src.nonexistent", "tx.pdus_in")
        with pytest.raises(KeyError):
            fg.nodes["tx"].deliver("nonexistent", None)
        fg.nodes["src"].obj.bus = None
        with pytest.raises(ValueError, match="no bus"):
            fg._connect("src.pdus", "tx.pdus_in")

    def test_a_graph_without_sources_does_not_run(self):
        fg = graph("loopback")
        del fg.nodes["src"]
        with pytest.raises(ValueError, match="no source"):
            fg.run(1)
