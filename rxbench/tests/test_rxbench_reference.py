"""The reference receiver: against the program's receiver on the CPU, on the
benchmark's own stream, and its control."""

import dataclasses

import numpy as np
import pytest
import torch

from rxbench import compare, frame as fr, reference, tx, windows

CONFIGS = ("qpsk_v27_golay24", "qpsk_uncoded")
CPU = torch.device("cpu")
F32 = reference.Precision("float32")


@pytest.mark.parametrize("name", CONFIGS)
def test_equals_the_programs_receiver_on_the_cpu(name):
    """On the CPU the program runs its kernels' plain versions: the reference
    repeats its arithmetic, so every field agrees exactly."""
    from liquiddsp_tpu_torch.core.config import FrameConfig
    from liquiddsp_tpu_torch.phy.framesync import framesync_fixed

    cfg = fr.load_config(name)
    pool = tx.make_pool(cfg, 3, 12288, 2, 41, CPU)
    x = windows.stream_window(pool, 1, cfg.overlap, CPU)
    k = fr.slots_for(cfg, 12288)
    got = reference.decode_block(x, cfg, k, F32)
    want = framesync_fixed(x, FrameConfig(cfg.modulation, cfg.inner_code, cfg.outer_code,
                                          cfg.payload_len), k, threshold=cfg.threshold, device=CPU)
    assert int(got["mask"].sum()) > 0
    for f, v in got.items():
        w = getattr(want, f)
        assert torch.equal(v.to(torch.float64), w.to(torch.float64)), f


@pytest.mark.parametrize("name", CONFIGS)
def test_decodes_the_benchmarks_stream(name):
    """Every frame of a small circle comes back bit-exactly once over the
    pool's windows, those across chunk edges and the wrap too."""
    cfg = fr.load_config(name)
    chunk_len, n = 12288, 3
    pool = tx.make_pool(cfg, 4, chunk_len, n, 2**31 + 5, CPU)
    circle = n * chunk_len
    frames = []
    for i in range(n):
        got = windows.stream_frames(pool, i, cfg, fr.slots_for(cfg, chunk_len), F32, CPU)
        base = i * chunk_len - cfg.overlap  # the window's first sample in the stream
        got["abs"] = base + np.mod(got["pos"] - base, circle)
        frames.append(got)
    attempted, failed = compare.account(frames, pool.layout, pool.payload, pool.user,
                                        -cfg.overlap, circle - cfg.overlap)
    assert attempted >= pool.layout.starts.size - 2  # a frame a sample from either end is not counted
    assert failed == 0


def test_sharded_windows_keep_the_stream_windows_frames():
    """Cut into time shards, a window keeps the same frames with the same
    payloads (at a high SNR, where the shard cut changes no decision)."""
    cfg = dataclasses.replace(fr.load_config("qpsk_uncoded"), snr_db=40.0)
    chunk_len = 16384
    pool = tx.make_pool(cfg, 2, chunk_len, 2, 8, CPU)
    a = windows.stream_frames(pool, 1, cfg, fr.slots_for(cfg, chunk_len), F32, CPU)
    b = windows.sharded_frames(pool, 1, cfg, 4, fr.slots_for(cfg, chunk_len // 4 + 300), F32, CPU)
    key = lambda f: sorted(zip(f["row"].tolist(), f["pos"].tolist()))
    assert key(a) == key(b) and len(key(a)) > 10
    oa, ob = np.lexsort((a["pos"], a["row"])), np.lexsort((b["pos"], b["row"]))
    assert np.array_equal(a["payload"][oa], b["payload"][ob])


@pytest.mark.parametrize("workload", ["v27golay.chunks", "uncoded.chunks", "v27golay.sharded8"])
def test_control_is_not_correct(workload):
    """The control: the reference in bfloat16 in the program's place, on the
    cell's pool at a size the CPU holds. The same frames and bytes come back,
    with statistics that the cell's limits refuse."""
    from rxbench import control, spec

    small = {"batch": 2, "chunk_len": 12288, "pool_chunks": 2}
    if workload.endswith("sharded8"):
        small.update(batch=1, chunk_len=24576, n_time=2)
    cell = spec.load_cell(workload, traffic_override=small)
    nums = control.control_numbers(cell, 17, CPU)
    assert nums["frames_differ"] == 0
    ok, rows = compare.held(nums, cell.limits)
    assert not ok, rows
