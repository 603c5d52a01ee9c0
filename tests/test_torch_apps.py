"""The port's adaptation and supervised-rx demos on the CPU.

- ``apps/adaptation_demo``: the loop (framegen, AWGN from the numpy
  generator, FlexRx, the cognitive engine) for 30 packets; the feedback it
  gave the engine, replayed packet by packet into the JAX package's
  ``CognitiveEngineBlock`` with the same settings and seed, must give the
  same decisions (as ``tests/test_torch_adapt_loop.py`` does for the batched
  loop), and a valid payload is the one that was sent.
- ``apps/supervised_rx_demo``: two supervised workers, one killed once
  mid-stream, end in 12/12 frames decoded exactly once and ``restarts=[1, 0]``,
  as the reference demo does.
"""

import os
import subprocess
import sys

import pytest
import torch

from liquiddsp_tpu.engine.cognitive_engine import CognitiveEngineBlock as JBlock
from liquiddsp_tpu_torch.apps import adaptation_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [
    ["--packets", "30"],
    ["--packets", "30", "--dynamic", "--ce", "annealing_epsilon_greedy", "--seed", "3"],
], ids=["stationary", "dynamic"])
def test_adaptation_demo_replays_into_the_jax_engine(argv, capsys):
    out = adaptation_demo.main(["--cpu", *argv])
    args = adaptation_demo.parse_args(argv)
    assert len(out["feedback"]) == len(out["decisions"]) == 30
    ref = JBlock(ce_type=args.ce, kindicator=args.kindicator,
                 channel="nonstationary" if args.dynamic else "stationary", seed=args.seed)
    for fb, decision in zip(out["feedback"], out["decisions"]):
        if args.dynamic:
            ref.get_number()
        assert ref.handler(fb) == decision
    assert sum(fb["payload_valid"] for fb in out["feedback"]) > 0
    assert len({(d["modulation"], d["inner_code"], d["outer_code"]) for d in out["decisions"]}) > 1
    assert "final avg goodput" in capsys.readouterr().out


def test_supervised_demo_resumes_the_killed_worker_exactly_once():
    proc = subprocess.run(
        [sys.executable, "-m", "liquiddsp_tpu_torch.apps.supervised_rx_demo", "--cpu",
         "--workers", "2", "--chunks", "6", "--kill", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "total: 12/12 frames decoded exactly once; restarts=[1, 0]" in proc.stdout, proc.stdout
    assert "simulated crash after chunk 2" in proc.stdout
    assert "worker 0: 6/6 frames, 0 duplicates, resumed=True" in proc.stdout


@pytest.mark.parametrize("demo,argv", [
    ("adaptation_demo", ["--packets", "1"]),
    ("supervised_rx_demo", ["--workers", "1"]),
    ("sharded_rx_demo", []),
])
def test_demos_raise_without_a_card(demo, argv):
    """Without --cpu every demo runs on the GPU: with no card visible it
    raises and does not carry on on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", f"liquiddsp_tpu_torch.apps.{demo}", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr, proc.stderr[-2000:]
