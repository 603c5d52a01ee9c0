"""Fault tolerance of the PyTorch port: StreamingRx checkpoints load across
the two packages (the same npz format), and a supervised worker that runs
the port on the CPU and is killed mid-stream resumes from its checkpoint
and decodes every frame exactly once (the analog of
tests/test_supervisor.py's crash-and-restart case)."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.runtime import supervisor as jsupervisor
from liquiddsp_tpu.runtime.stream import StreamingRx as JStreamingRx
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.runtime.stream import StreamingRx
from liquiddsp_tpu_torch.runtime.supervisor import (
    Heartbeat,
    Supervisor,
    WorkerSpec,
    load_stream_state,
    save_stream_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG, CHUNK = (1, 0, 0, 64), 2048

# Decodes a stream of 6 chunks with one frame a chunk, each but the first
# straddling a chunk boundary, checkpointing carry, position and tally after
# every chunk; dies (os._exit(9)) once after chunk ``die_after``.
STREAM_WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[3])
import numpy as np
import torch
torch.set_num_threads(1)
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.runtime.stream import StreamingRx
from liquiddsp_tpu_torch.runtime.supervisor import Heartbeat, load_stream_state, save_stream_state

work_dir, die_after = sys.argv[1], int(sys.argv[2])
hb = Heartbeat(os.path.join(work_dir, "hb"))
ckpt = os.path.join(work_dir, "state.npz")
cfg = FrameConfig(1, 0, 0, 64)
chunk, n_chunks = 2048, 6
rng = np.random.default_rng(0)
payloads = rng.integers(0, 256, (n_chunks, 64), dtype=np.uint8)
frames = framegen.framegen(payloads, cfg, device="cpu").numpy()
f = frames.shape[1]
stream = np.zeros((1, n_chunks * chunk), dtype=np.complex64)
starts = [300] + [chunk * (i + 1) - f // 2 for i in range(n_chunks - 1)]
for s, fr in zip(starts, frames):
    stream[0, s : s + f] = fr

rx = StreamingRx(cfg, batch=1, chunk_len=chunk, device="cpu")
extra = load_stream_state(ckpt, rx)
decoded = [int(s) for s in extra["decoded"]] if extra else []
while (i := rx._samples_consumed // chunk) < n_chunks:
    hb.beat()
    res = rx.step(stream[:, i * chunk : (i + 1) * chunk])
    for k in np.nonzero(res.mask[0].numpy())[0]:
        assert bool(res.payload_valid[0, k])
        decoded.append(res.epoch + int(res.start[0, k]))
    save_stream_state(ckpt, rx, decoded=np.asarray(decoded, dtype=np.int64))
    if i + 1 == die_after and not os.path.exists(os.path.join(work_dir, "died")):
        open(os.path.join(work_dir, "died"), "w").write("1")
        os._exit(9)
json.dump({"decoded": decoded, "chunks_done": rx._samples_consumed // chunk},
          open(os.path.join(work_dir, "tally.json"), "w"))
"""


def test_crash_restart_resumes_stream_exactly_once(tmp_path):
    wd = str(tmp_path)
    script = tmp_path / "worker.py"
    script.write_text(STREAM_WORKER)
    events = []
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    sup = Supervisor(
        [WorkerSpec(name="rx0", argv=[sys.executable, str(script), wd, "3", REPO],
                    heartbeat_path=os.path.join(wd, "hb"), stale_after_s=120.0,
                    max_restarts=2)],
        on_event=lambda n, ev, d: events.append((ev, d)), env=env)
    sup.start()
    summary = sup.run(poll_interval_s=0.25, timeout_s=300)[0]
    assert summary["restarts"] == 1 and not summary["gave_up"], (summary, events)
    assert summary["returncode"] == 0
    assert [ev for ev, _ in events] == ["start", "exit", "restart", "start"]
    tally = json.load(open(os.path.join(wd, "tally.json")))
    assert tally["chunks_done"] == 6
    # 6 frames, one a chunk, the one whose head lived only in the carry
    # checkpointed at the crash included: each exactly once
    got = sorted(set(tally["decoded"]))
    assert len(tally["decoded"]) == len(got) == 6, tally
    assert got[0] in range(299, 302)


def random_carry(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    """carry_re / carry_im / samples_consumed / extra_*: a checkpoint of
    either package restores the other's receiver exactly."""
    rng = np.random.default_rng(4)
    port = StreamingRx(FrameConfig(*CFG), batch=2, chunk_len=CHUNK, device="cpu")
    jrx = JStreamingRx(JFrameConfig(*CFG), batch=2, chunk_len=CHUNK)
    carry = random_carry(rng, (2, port.overlap))
    pos = (1 << 31) + 12345  # past int32: the position is a python int
    path = str(tmp_path / "state.npz")
    tally = np.arange(7, dtype=np.int64)
    if writer == "port":
        port._carry, port._samples_consumed = torch.from_numpy(carry), pos
        save_stream_state(path, port, decoded=tally)
        extra = jsupervisor.load_stream_state(path, jrx)
        got_carry, got_pos = np.asarray(jrx._carry), jrx._samples_consumed
    else:
        jrx._carry, jrx._samples_consumed = jnp.asarray(carry), pos
        jsupervisor.save_stream_state(path, jrx, decoded=tally)
        extra = load_stream_state(path, port)
        got_carry, got_pos = port._carry.numpy(), port._samples_consumed
        assert port._buf.shape == (2, port.overlap + CHUNK)
    np.testing.assert_array_equal(got_carry, carry)
    assert got_pos == pos and set(extra) == {"decoded"}
    np.testing.assert_array_equal(extra["decoded"], tally)
    d = np.load(path)
    assert sorted(d.files) == ["carry_im", "carry_re", "extra_decoded", "samples_consumed"]
    assert d["carry_re"].dtype == np.float32 and d["samples_consumed"].dtype == np.int64


def test_load_without_checkpoint_and_heartbeat(tmp_path):
    rx = StreamingRx(FrameConfig(*CFG), batch=1, chunk_len=CHUNK, device="cpu")
    assert load_stream_state(str(tmp_path / "none.npz"), rx) is None
    other = StreamingRx(FrameConfig(1, 1, 1, 64), batch=1, chunk_len=4096, device="cpu")
    save_stream_state(str(tmp_path / "s.npz"), other)
    with pytest.raises(ValueError, match="does not fit"):
        load_stream_state(str(tmp_path / "s.npz"), rx)
    hb = Heartbeat(str(tmp_path / "hb"))
    hb.beat()
    hb.beat()
    assert open(tmp_path / "hb").read().split()[0] == "2"
