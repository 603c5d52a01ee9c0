"""The port's own ctypes binding of the native C++ streaming runtime
(native/sdr_runtime.cpp, built with native/Makefile at first use), and its
chunked source feeding the port's StreamingRx on the CPU: the same results
as ``StreamingRx.run`` on the whole stream."""

import time

import numpy as np
import pytest
import torch

from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.runtime.native import (
    Counters,
    MessageQueue,
    NativeChunkSource,
    RingBuffer,
    StreamSource,
)
from liquiddsp_tpu_torch.runtime.stream import StreamingRx


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ring_roundtrip_wraparound_overlap_and_backpressure():
    rb = RingBuffer(256)
    for it in range(10):  # wraps around
        data = np.full(200, it, dtype=np.uint8)
        assert rb.write(data) == 200 and rb.readable == 200
        np.testing.assert_array_equal(rb.read_overlap(200, 0), data)
    rb = RingBuffer(1024)
    rb.write(np.arange(300, dtype=np.uint16).view(np.uint8))
    a, b = rb.read_overlap(200, 40), rb.read_overlap(200, 40)
    np.testing.assert_array_equal(a[160:], b[:40])  # the carry is read again
    assert rb.read_overlap(1000, 0) is None
    small = RingBuffer(128)
    assert small.write(np.zeros(200, dtype=np.uint8)) == 128 and small.writable == 0


def test_message_queue_counters_and_threaded_source():
    mq = MessageQueue(max_msgs=3)
    assert all(mq.put({"seq": i}) for i in range(3)) and not mq.put({"seq": 3})
    assert mq.dropped == 1 and len(mq) == 3
    assert [mq.get()["seq"] for _ in range(3)] == [0, 1, 2] and mq.get(timeout_ms=20) is None
    c = Counters(["frames", "errors"])
    c.add("frames", 5)
    c.add("frames")
    c.add("errors", 2)
    assert c.report() == {"frames": 6, "errors": 2}
    rb = RingBuffer(1 << 16)
    samples = (np.arange(5000) % 251).astype(np.uint8)
    src = StreamSource(rb, samples)
    got, deadline = [], time.time() + 5
    while sum(len(g) for g in got) < 5000 and time.time() < deadline:
        r = rb.read_overlap(1000, 0)
        if r is not None:
            got.append(r)
    src.stop()
    np.testing.assert_array_equal(np.concatenate(got)[:5000], samples)


def test_chunk_source_rereads_the_overlap():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.complex64)
    chunks = list(NativeChunkSource(x, chunk_len=1024, overlap=128).chunks())
    assert len(chunks) >= 3
    np.testing.assert_array_equal(chunks[0][-128:], chunks[1][:128])
    flat = np.concatenate([chunks[0]] + [c[128:] for c in chunks[1:]])
    np.testing.assert_array_equal(flat, x[: len(flat)])


def test_chunk_source_feeds_streaming_rx_as_run_does():
    """Frames straddling both chunk boundaries and one clear of them: the
    native chunks through ``step`` give what ``run`` gives, field by field,
    and every payload sent."""
    cfg = FrameConfig(1, 0, 0, 32)
    rng = np.random.default_rng(3)
    payloads = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    frames = framegen.framegen(payloads, cfg, device="cpu").numpy()
    chunk, f = 2048, frames.shape[1]
    x = np.zeros(3 * chunk, dtype=np.complex64)
    for i, s in enumerate([chunk - f // 2, 2 * chunk - f // 2, 2 * chunk + f]):
        x[s : s + f] = frames[i]
    rx = StreamingRx(cfg, batch=1, chunk_len=chunk, max_frames_per_chunk=4, device="cpu")
    fed = [rx.step(c[None, :]) for c in NativeChunkSource(x, chunk_len=chunk).chunks()]
    ref = StreamingRx(cfg, batch=1, chunk_len=chunk, max_frames_per_chunk=4, device="cpu").run(x[None])
    assert len(fed) == len(ref) == 3
    for a, b in zip(fed, ref):
        for name, v in b.to_numpy().items():
            np.testing.assert_array_equal(a.to_numpy()[name], v, err_msg=name)
    got = {bytes(r.payload[0, k].numpy()) for r in fed for k in np.nonzero(r.payload_valid[0].numpy())[0]}
    assert got == {bytes(p) for p in payloads}
