"""The PyTorch port imports without jax, and never carries on on the CPU
when it finds no GPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import liquiddsp_tpu_torch
import liquiddsp_tpu_torch.phy.framegen, liquiddsp_tpu_torch.phy.framesync
import liquiddsp_tpu_torch.phy.detector, liquiddsp_tpu_torch.phy.tables
import liquiddsp_tpu_torch.kernels.correlator, liquiddsp_tpu_torch.kernels.extract
import liquiddsp_tpu_torch.kernels.recover, liquiddsp_tpu_torch.kernels.viterbi
import liquiddsp_tpu_torch.kernels.halo, liquiddsp_tpu_torch.parallel.mesh
import liquiddsp_tpu_torch.parallel.halo, liquiddsp_tpu_torch.utils.metrics
import liquiddsp_tpu_torch.runtime.distributed_stream, liquiddsp_tpu_torch.ops.fec.rs
import liquiddsp_tpu_torch.ops.fec.block, liquiddsp_tpu_torch.ops.modem
import liquiddsp_tpu_torch.streams, liquiddsp_tpu_torch.dryrun
import liquiddsp_tpu_torch.profile_step, liquiddsp_tpu_torch.config_space
import liquiddsp_tpu_torch.profile_halo
import liquiddsp_tpu_torch.runtime.blocks, liquiddsp_tpu_torch.runtime.bus
import liquiddsp_tpu_torch.runtime.sim, liquiddsp_tpu_torch.ops.resample
import liquiddsp_tpu_torch.runtime.stream, liquiddsp_tpu_torch.runtime.supervisor
import liquiddsp_tpu_torch.runtime.native, liquiddsp_tpu_torch.adapt_loop
import liquiddsp_tpu_torch.engine, liquiddsp_tpu_torch.engine.estimators
import liquiddsp_tpu_torch.engine.store, liquiddsp_tpu_torch.engine.knowledge
import liquiddsp_tpu_torch.engine.bandits, liquiddsp_tpu_torch.engine.cognitive_engine
import liquiddsp_tpu_torch.ops.agc, liquiddsp_tpu_torch.ops.nco, liquiddsp_tpu_torch.ops.fir
import liquiddsp_tpu_torch.golden, liquiddsp_tpu_torch.grc.loader
import liquiddsp_tpu_torch.apps.loopback_demo, liquiddsp_tpu_torch.apps.flowgraph_demo
import liquiddsp_tpu_torch.apps.adaptation_demo, liquiddsp_tpu_torch.apps.supervised_rx_demo
import liquiddsp_tpu_torch.apps.sharded_rx_demo, liquiddsp_tpu_torch.parallel.peer
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "liquiddsp_tpu" or m.startswith("liquiddsp_tpu.")]
print("LEAKED", bad)
"""


def test_import_leaves_jax_and_reference_package_out():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_no_source_file_imports_jax_or_reference_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|liquiddsp_tpu)(\.|\s|$)", re.M)
    files = list((REPO / "liquiddsp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_every_port_descriptor_names_a_port_class():
    """The port's YAML block descriptors and graphs are its own: every
    factory is a class of liquiddsp_tpu_torch, every graph block one of the
    port's descriptors."""
    import yaml

    grc = REPO / "liquiddsp_tpu_torch" / "grc"
    descriptors = sorted(grc.glob("*.yaml"))
    assert len(descriptors) == 6
    for path in descriptors:
        factory = yaml.safe_load(path.read_text())["factory"]
        assert factory.startswith("liquiddsp_tpu_torch."), (path.name, factory)
    names = {p.stem for p in descriptors}
    graphs = sorted((grc / "graphs").glob("*.yaml"))
    assert [g.name for g in graphs] == ["adaptation_loop.yaml", "loopback.yaml"]
    for g in graphs:
        assert {b["block"] for b in yaml.safe_load(g.read_text())["blocks"]} <= names


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None is allowed to run")


@pytest.mark.parametrize("entry", ["framegen", "detect", "framesync_fixed", "phy_tables",
                                   "make_mesh", "long_stream", "dryrun_sharded", "FlexTx",
                                   "FlexRx", "FrameDetectorCC", "ChannelModel",
                                   "config_space_loopback", "StreamingRx", "adapt_loop",
                                   "Flowgraph", "resampled_stream", "fade_slip_symbols",
                                   "loopback_demo", "flowgraph_demo"])
def test_entry_points_raise_without_gpu(entry):
    """device=None means the GPU; without one the call raises instead of
    running on the CPU."""
    _no_gpu()
    import liquiddsp_tpu_torch
    from liquiddsp_tpu_torch import FrameConfig, streams
    from liquiddsp_tpu_torch.adapt_loop import adapt_loop
    from liquiddsp_tpu_torch.parallel import mesh
    from liquiddsp_tpu_torch.config_space import config_space_loopback
    from liquiddsp_tpu_torch.phy import detector, framegen, framesync, tables
    from liquiddsp_tpu_torch.runtime import blocks, sim, stream
    from liquiddsp_tpu_torch.apps import flowgraph_demo, loopback_demo
    from liquiddsp_tpu_torch.grc.loader import Flowgraph

    cfg = FrameConfig(1, 0, 0, 64)
    x = torch.zeros((1, 2048), dtype=torch.complex64)
    calls = {
        "framegen": lambda: framegen.framegen(torch.zeros((1, 64), dtype=torch.uint8), cfg),
        "detect": lambda: detector.detect(x, 2),
        "framesync_fixed": lambda: framesync.framesync_fixed(x, cfg, 2),
        "phy_tables": lambda: tables.phy_tables(cfg),
        "make_mesh": lambda: mesh.make_mesh(n_time=4),
        "long_stream": lambda: streams.long_stream(cfg, 20.0, 1, 4096, torch.Generator()),
        "dryrun_sharded": lambda: liquiddsp_tpu_torch.dryrun_sharded(2),
        "FlexTx": lambda: blocks.FlexTx(),
        "FlexRx": lambda: blocks.FlexRx(),
        "FrameDetectorCC": lambda: blocks.FrameDetectorCC(),
        "ChannelModel": lambda: sim.ChannelModel(),
        "config_space_loopback": lambda: config_space_loopback(),
        "StreamingRx": lambda: stream.StreamingRx(cfg, batch=1, chunk_len=4096),
        "adapt_loop": lambda: adapt_loop(batch=1, iters=1),
        "Flowgraph": lambda: Flowgraph.load(str(REPO / "liquiddsp_tpu_torch/grc/graphs/loopback.yaml")),
        "resampled_stream": lambda: streams.resampled_stream(
            cfg, 20.0, 4, 8192, streams.RESAMPLED_PPMS, torch.Generator()),
        "fade_slip_symbols": lambda: streams.fade_slip_symbols(cfg, 1, 0),
        "loopback_demo": lambda: loopback_demo.main(["--packets", "1"]),
        "flowgraph_demo": lambda: flowgraph_demo.main(["--packets", "1"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_chip_smoke_fails_without_gpu():
    _no_gpu()
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_sharded_receiver_raises_on_a_gpu_mesh_without_gpu_and_runs_on_cpu():
    """A mesh of CUDA devices means the GPU: without one the sharded receiver
    and its streaming wrapper raise instead of running on the CPU, while a
    mesh built with devices=["cpu"] runs."""
    _no_gpu()
    from liquiddsp_tpu_torch import FrameConfig
    from liquiddsp_tpu_torch.parallel.halo import shard_stream, sharded_framesync
    from liquiddsp_tpu_torch.parallel.mesh import make_mesh
    from liquiddsp_tpu_torch.runtime.distributed_stream import ShardedStreamingRx

    cfg = FrameConfig(1, 0, 0, 64)
    x = torch.zeros((1, 4096), dtype=torch.complex64)
    gpu = make_mesh(n_time=2, n_ch=1, devices=["cuda:0"])
    for call in (lambda: sharded_framesync(x, cfg, gpu), lambda: shard_stream(x, gpu),
                 lambda: ShardedStreamingRx(cfg, gpu, batch=1, chunk_len=8192)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    res = sharded_framesync(x, cfg, make_mesh(n_time=2, n_ch=1, devices=["cpu"]), 2)
    assert res.mask.shape == (1, 4) and not bool(res.mask.any())


def test_unported_paths_raise_not_implemented():
    """What is not built raises: a mesh over several devices in one process
    (a card is a process of its own, init_distributed). What this package
    has ported since no longer does: the sample-clock-drift path for frames
    of 2200 symbols and more, the differential modems, Reed-Solomon, the
    Hamming and SEC-DED codes."""
    from liquiddsp_tpu_torch import FrameConfig
    from liquiddsp_tpu_torch.ops import modem
    from liquiddsp_tpu_torch.ops.fec import registry
    from liquiddsp_tpu_torch.parallel.mesh import make_mesh
    from liquiddsp_tpu_torch.phy import framegen, framesync

    long_cfg = FrameConfig(0, 1, 1, 64)  # BPSK + V27 + Golay: 2416 symbols
    x = torch.zeros((1, 8192), dtype=torch.complex64)
    res = framesync.framesync_fixed(x, long_cfg, 1, device="cpu")
    assert res.symbols.shape == (1, 1, 2416) and not bool(res.mask.any())
    with pytest.raises(NotImplementedError, match="init_distributed"):
        make_mesh(devices=["cpu", "meta"])

    assert modem.modulate(torch.zeros(4, dtype=torch.int32), 4).shape == (4,)  # DPSK2
    coded = registry.outer_encode(torch.zeros((1, 8), dtype=torch.uint8), 2)  # RS
    assert registry.outer_decode(coded, 8, 2).shape == (1, 8)
    assert registry.outer_decode(torch.zeros((1, 14), dtype=torch.int8), 1, 3).shape == (1, 1)
    frames = framegen.framegen(np.zeros((1, 64), np.uint8), FrameConfig(4, 0, 0, 64), device="cpu")
    assert frames.shape == (1, framegen.frame_length(FrameConfig(4, 0, 0, 64)))
