"""The closed adaptation loop of the PyTorch port (TX -> AWGN -> FlexRx ->
cognitive engine) on the CPU at a small size, replayed into the JAX
package's engine: the feedback the loop recorded, fed generation by
generation to a JAX ``CognitiveEngineBlock`` with the same seed, must give
the same decisions in every generation, and no frame may pass its CRC with
bytes other than those sent."""

import numpy as np
import pytest
import torch

from liquiddsp_tpu.engine.cognitive_engine import CognitiveEngineBlock as JBlock
from liquiddsp_tpu_torch.adapt_loop import adapt_loop, block_samples
from liquiddsp_tpu_torch.phy import frame_spec as fs

BATCH, ITERS = 4, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pipeline,dynamic", [(False, False), (True, False), (False, True)],
                         ids=["unpipelined", "pipelined", "dynamic"])
def test_loop_replays_into_the_jax_engine(pipeline, dynamic):
    out = adapt_loop(batch=BATCH, iters=ITERS, pipeline=pipeline, dynamic=dynamic, device="cpu")
    assert out["packets"] == BATCH * ITERS and out["pipeline"] is pipeline
    assert out["payload_exact"] == out["payload_valid"] > 0
    assert len(out["feedback"]) == len(out["decisions"]) == len(out["commanded"]) == ITERS
    assert out["block_samples"] == block_samples(32) == 256 + fs.max_frame_spec(32).frame_samples + 256
    ref = JBlock(ce_type="epsilon_greedy", channel="nonstationary" if dynamic else "stationary",
                 seed=0)
    for fbs, decisions in zip(out["feedback"], out["decisions"]):
        assert len(fbs) == BATCH
        if dynamic:
            ref.get_number()
        assert ref.handle_batch(fbs) == decisions
    assert out["configs_visited"] == len({r.config_id for r in ref.store.rx_log})
    # the first generation is sent on (1,0,0); each later one on the
    # decisions of the generation before (two before, with the pipeline)
    lag = 2 if pipeline else 1
    assert out["commanded"][0] == [(1, 0, 0)] * BATCH
    for g in range(lag, ITERS):
        assert out["commanded"][g] == [
            (d["modulation"], d["inner_code"], d["outer_code"]) for d in out["decisions"][g - lag]]
    # a lost frame reports failure on the config it was commanded
    for cmd, fbs in zip(out["commanded"], out["feedback"]):
        for c, fb in zip(cmd, fbs):
            if not fb["header_valid"]:
                assert (fb["modulation"], fb["inner_code"], fb["outer_code"]) == c
                assert fb["payload_valid"] == 0
    last = out["decisions"][-1]
    if not pipeline:
        assert out["final_configs"] == sorted(
            {(d["modulation"], d["inner_code"], d["outer_code"]) for d in last})


def test_same_seed_same_run_and_another_seed_differs():
    a = adapt_loop(batch=BATCH, iters=3, device="cpu")
    b = adapt_loop(batch=BATCH, iters=3, device="cpu")
    c = adapt_loop(batch=BATCH, iters=3, seed=1, device="cpu")
    assert a["decisions"] == b["decisions"] and a["feedback"] == b["feedback"]
    assert np.array_equal([fb["payload_valid"] for g in a["feedback"] for fb in g],
                          [fb["payload_valid"] for g in b["feedback"] for fb in g])
    assert c["decisions"] != a["decisions"]
